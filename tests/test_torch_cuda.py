"""The port's CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA card (``cuda`` marker); skips without one. It imports
neither JAX nor the JAX package, so on the card's machine, which has no JAX,
it runs without the suite's conftest:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed and cast to bf16; tolerance 2e-2,
for O(1) outputs in bf16. Each case also checks that the wrapper counted
exactly one launch.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import attention as tatt

TOL = 2e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,Dh,kw", [
    (8, 2, 128, {}),
    (8, 2, 128, {"softcap": 50.0, "window": 48}),
    (4, 4, 64, {"scale": 0.2}),
    (8, 4, 256, {"softcap": 30.0}),
])
def test_flash_kernel_matches_plain(Hq, Hkv, Dh, kw):
    dev = _card()
    rng = np.random.default_rng(5)
    B, T, S = 2, 80, 200               # ragged edges on both tiles
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, T, Hq, Dh), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, Dh), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, Dh), np.float32))
    q, k, v = (x.to(dev, bf) for x in (q, k, v))
    q_pos = (torch.arange(S - T, S, dtype=torch.int32)[None]
             .repeat(B, 1).to(dev))
    k_pos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1).to(dev)
    k_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    k_valid[1, 150:] = False
    k_valid[1, 0] = False
    q_pos[1, T - 8:] = 0               # padded rows: nothing visible -> 0
    n0 = tatt.flash_attention.launches
    got = tatt.flash_attention(q, k, v, q_pos, k_pos, k_valid, **kw).float()
    want = tatt.flash_attention_plain(q, k, v, q_pos, k_pos, k_valid,
                                      **kw).float()
    assert tatt.flash_attention.launches == n0 + 1
    assert (got - want).abs().max().item() <= TOL
    assert got[1, T - 8:].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("page,Dh,kw", [
    (64, 128, {}),
    (64, 128, {"softcap": 50.0, "window": 96}),
    (16, 64, {}),
    (32, 256, {"window": 40}),
])
def test_paged_kernel_matches_plain(page, Dh, kw):
    dev = _card()
    rng = np.random.default_rng(6)
    B, Hkv, G, P = 4, 2, 4, 4
    n_pages = B * P + 1
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, Dh), np.float32))
    kp = torch.from_numpy(rng.standard_normal((Hkv, n_pages, page, Dh),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((Hkv, n_pages, page, Dh),
                                              np.float32))
    q, kp, vp = (x.to(dev, bf) for x in (q, kp, vp))
    pt = torch.from_numpy((rng.permutation(n_pages - 1)[:B * P] + 1)
                          .reshape(B, P).astype(np.int32)).to(dev)
    lengths = torch.tensor([1, page, page + 3, P * page], dtype=torch.int32,
                           device=dev)
    n0 = tatt.paged_attention.launches
    got = tatt.paged_attention(q, kp, vp, pt, lengths, **kw).float()
    want = tatt.paged_attention_plain(q, kp, vp, pt, lengths, **kw).float()
    assert tatt.paged_attention.launches == n0 + 1
    assert (got - want).abs().max().item() <= TOL
