"""Key helpers for the ``mobility/`` keyspace family.

Three record kinds, all JSON values (see ``docs/keyspace.md``):

- ``mobility/{ns}/prefetch/{component}`` — arbiter/operator hint: the
  list of candidate sibling models a component's workers should stage
  into their host weight cache while serving. Written by the fleet plane
  each arbitration tick (swap-group siblings) and by
  ``ctl fleet add --prewarm``; read (watched) by the worker's
  :class:`~dynamo_tpu_torch.fleet.mobility.agent.MobilityAgent`.
- ``mobility/{ns}/swap/{component}`` — swap command (the SIGUSR1-style
  control message): tells one worker of ``component`` to drain and
  hot-swap into the named sibling model. The executing worker deletes
  the key as its claim; a rare double-claim only over-swaps by one
  worker, which the next planner tick corrects.
- ``mobility/{ns}/wake/{model}`` — last wake record for a model:
  ``{"path": "swap"|"cold", "seconds": float, "at": ts, "worker": id}``.
  Read by ``GET /v1/models``, dyntop and the soak wake lane.
"""

from __future__ import annotations

PREFIX = "mobility/"


def mobility_prefix(namespace: str) -> str:
    """Every mobility record of one namespace — the agent's single watch
    (filtering live means a post-swap component change needs no re-arm)."""
    return f"{PREFIX}{namespace}/"


def mobility_prefetch_key(namespace: str, component: str) -> str:
    return f"{PREFIX}{namespace}/prefetch/{component}"


def mobility_swap_key(namespace: str, component: str) -> str:
    return f"{PREFIX}{namespace}/swap/{component}"


def mobility_wake_key(namespace: str, model: str) -> str:
    return f"{PREFIX}{namespace}/wake/{model}"


def mobility_wake_prefix(namespace: str) -> str:
    return f"{PREFIX}{namespace}/wake/"
