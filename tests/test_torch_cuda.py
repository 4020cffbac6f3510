"""The port's CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA card (``cuda`` marker); skips without one. It imports
neither JAX nor the JAX package, so on the card's machine, which has no JAX,
it runs without the suite's conftest:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed and cast to bf16; tolerance 2e-2,
for O(1) outputs in bf16. Each case also checks that the wrapper counted
its launches. ``test_paged_split_plan`` checks the paged kernel's host-side
split plan and runs on the CPU. The engine tests at the end serve the
CLI's default tiny-byte (Dh=16), check the construction-time kernel check,
and enqueue a chained decode dispatch under
``torch.cuda.set_sync_debug_mode("error")``.
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
    # the tiny presets' heads: tiny-byte, and tiny-gemma's one kv head
    (4, 2, 16, {}),
    (4, 1, 16, {"softcap": 50.0, "window": 48}),
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


def _gather_view(pool, read_idx, page):
    """[Hkv, n_pages, page, Dh] pool -> the strided [B, S, Hkv, Dh] view of
    its gather that ``models/llama.forward`` hands to the kernel."""
    rp, ro = read_idx // page, read_idx % page
    return pool[:, rp, ro].permute(1, 2, 0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("G,Dh,gather,kw", [
    (1, 64, False, {}),
    (4, 128, True, {}),
    (8, 128, True, {"window": 20}),          # window < one key tile
    (8, 64, False, {"window": 20, "softcap": 30.0}),
    (4, 256, True, {"window": 20}),
    (1, 256, False, {"softcap": 50.0}),
    (8, 256, True, {}),
    (2, 16, True, {}),
    (4, 16, False, {"window": 20}),
])
def test_flash_kernel_tiling(G, Dh, gather, kw):
    """Rows of a block are (position, group head) pairs, so the positions a
    block covers change with G; T and S fit no tile; lane 1 has pad rows
    at position 0 (they see its key 0, as the engine's pad rows do) and
    lane 2 is all padding with no valid key, so it must be exactly 0."""
    dev = _card()
    rng = np.random.default_rng(7)
    B, T, S, Hkv, page = 3, 37, 203, 2, 16
    Hq = Hkv * G
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, T, Hq, Dh), np.float32))
    q = q.to(dev, bf)
    ctx = (S, 120, 0)                  # context length of each lane
    chunk = (T, 30, 0)                 # query rows of each lane
    q_pos = np.zeros((B, T), np.int32)
    k_pos = np.zeros((B, S), np.int32)
    k_valid = np.zeros((B, S), bool)
    for b in range(B):
        q_pos[b, :chunk[b]] = np.arange(ctx[b] - chunk[b], ctx[b])
        k_pos[b, :ctx[b]] = np.arange(ctx[b])
        k_valid[b, :ctx[b]] = True
    if gather:
        n_pages = 1 + B * (-(-S // page))
        kp, vp = (torch.from_numpy(rng.standard_normal(
            (Hkv, n_pages, page, Dh), np.float32)).to(dev, bf)
            for _ in range(2))
        slots = rng.permutation(np.arange(page, n_pages * page))[:B * S]
        read_idx = torch.from_numpy(slots.reshape(B, S)).to(dev)
        read_idx[~torch.from_numpy(k_valid).to(dev)] = 0   # scratch page
        k, v = _gather_view(kp, read_idx, page), _gather_view(vp, read_idx,
                                                               page)
        assert not k.is_contiguous()
    else:
        k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, Hkv, Dh), np.float32)).to(dev, bf) for _ in range(2))
    q_pos, k_pos, k_valid = (torch.from_numpy(a).to(dev)
                             for a in (q_pos, k_pos, k_valid))
    n0 = tatt.flash_attention.launches
    got = tatt.flash_attention(q, k, v, q_pos, k_pos, k_valid, **kw).float()
    want = tatt.flash_attention_plain(q, k, v, q_pos, k_pos, k_valid,
                                      **kw).float()
    assert tatt.flash_attention.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert got[2].abs().max().item() == 0.0


def _paged_lengths(spec, B, P, page, split):
    """Lengths of a paged case: the default mix, every lane at the table's
    P*page tokens ("full"), or one below, at and one above a split boundary
    plus a lane past the second boundary ("split")."""
    if spec is None:
        return [1, page, page + 3, P * page][:B]
    if spec == "full":
        return [P * page] * B
    if spec == "split":
        return [split - 1, split, split + 1, 2 * split + 3][:B]
    return list(spec)


@pytest.mark.cuda
@pytest.mark.parametrize("page,Dh,kw,shape", [
    (64, 128, {}, {}),
    (64, 128, {"softcap": 50.0, "window": 96}, {}),
    (16, 64, {}, {}),
    (32, 256, {"window": 40}, {}),
    # one sequence at the table's full 2048 tokens: the most splits
    (64, 128, {}, {"B": 1, "P": 32, "lengths": "full"}),
    # lengths at split - 1, split, split + 1 and past a second boundary
    (64, 128, {}, {"P": 32, "lengths": "split"}),
    (16, 64, {}, {"P": 64, "lengths": "split"}),
    (32, 256, {"softcap": 30.0}, {"P": 16, "lengths": "split"}),
    # a window straddling a split boundary, and one narrower than a tile
    (64, 128, {"window": "straddle"}, {"P": 32, "lengths": "split"}),
    (64, 128, {"window": 5}, {"P": 32, "lengths": "split"}),
    (128, 128, {}, {"B": 3, "P": 8, "lengths": (700, 1024, 129)}),
    # GQA groups of 1, 2 and 8 query heads (4 above); 6 (rows of the
    # block's 16 left idle) and 20 (two blocks of query heads)
    (64, 128, {}, {"G": 1, "P": 8}),
    (64, 64, {"window": 70}, {"G": 2, "P": 8}),
    (64, 128, {}, {"G": 8, "P": 8}),
    (16, 128, {}, {"G": 6, "P": 16}),
    (32, 64, {"softcap": 30.0}, {"G": 20, "P": 8}),
    # lengths above P*page clamp to it
    (32, 128, {}, {"P": 4, "lengths": (5000, 3, 128, 129)}),
    # the tiny presets' heads at Dh 16: tiny-byte (G=2) at the CLI's page
    # of 64, across split boundaries, and tiny-gemma (one kv head, G=4)
    (64, 16, {}, {"G": 2, "P": 8}),
    (16, 16, {"window": 20}, {"G": 2, "P": 16, "lengths": "split"}),
    (64, 16, {"softcap": 50.0}, {"G": 4, "Hkv": 1, "P": 8}),
])
def test_paged_kernel_matches_plain(page, Dh, kw, shape):
    """Each case also runs the same call twice: the split merge has a fixed
    order, so the two outputs must be bitwise equal."""
    dev = _card()
    rng = np.random.default_rng(6)
    B, G, P = shape.get("B", 4), shape.get("G", 4), shape.get("P", 4)
    Hkv = shape.get("Hkv", 2)
    Hq = Hkv * G
    split, nsplit = tatt.paged_split_plan(
        B, Hq, Hkv, Dh, P, page, tatt._sm_count(dev.index))
    lengths_l = _paged_lengths(shape.get("lengths"), B, P, page, split)
    kw = dict(kw)
    if kw.get("window") == "straddle":
        kw["window"] = split // 2 + 7
    n_pages = B * P + 1
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, Hq, Dh), np.float32))
    kp = torch.from_numpy(rng.standard_normal((Hkv, n_pages, page, Dh),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((Hkv, n_pages, page, Dh),
                                              np.float32))
    q, kp, vp = (x.to(dev, bf) for x in (q, kp, vp))
    pt = torch.from_numpy((rng.permutation(n_pages - 1)[:B * P] + 1)
                          .reshape(B, P).astype(np.int32)).to(dev)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    n0 = tatt.paged_attention.launches
    got = tatt.paged_attention(q, kp, vp, pt, lengths, **kw)
    again = tatt.paged_attention(q, kp, vp, pt, lengths, **kw)
    want = tatt.paged_attention_plain(q, kp, vp, pt, lengths, **kw).float()
    assert tatt.paged_attention.launches == n0 + 2
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL


@pytest.mark.parametrize("B,Hq,Hkv,Dh,P,page", [
    (8, 32, 8, 128, 32, 64),           # Llama-3-8B, 2048-token table
    (1, 32, 8, 128, 32, 64),           # one stream: splits are all there is
    (6, 32, 8, 128, 25, 64),           # the serve burst's decode shape
    (8, 16, 8, 256, 32, 64),           # Gemma2-9B heads
    (64, 64, 8, 128, 4, 16),           # wide batch, short table: one split
    (2, 28, 4, 128, 3, 16),            # G = 7, one block of query heads
    (1, 64, 2, 64, 1, 128),            # G = 32: two blocks of 16 heads
])
def test_paged_split_plan(B, Hq, Hkv, Dh, P, page):
    """The paged kernel's split plan, from shapes alone: a whole number of
    block rounds per split, the splits cover the table with no empty one,
    and the grid aims at PAGED_BLOCKS_PER_SM blocks an SM of an H100 where
    the table is long enough."""
    n_sm, granule = 132, 64
    split, nsplit = tatt.paged_split_plan(B, Hq, Hkv, Dh, P, page, n_sm,
                                          granule=granule)
    ctx = P * page
    assert split % granule == 0 and nsplit >= 1
    assert (nsplit - 1) * split < ctx <= nsplit * split
    blocks = B * Hkv * -(-(Hq // Hkv) // 16) * nsplit
    assert split == granule or \
        blocks >= tatt.PAGED_BLOCKS_PER_SM * n_sm // 2
    assert nsplit == 1 or blocks < 2 * tatt.PAGED_BLOCKS_PER_SM * n_sm


# ---------------------------------------------------------------------------
# KV block manager copies (llm/kvbm/transfer.py) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_copy_stream_round_trips_bf16_pages():
    """d2h of bf16 pages through pinned buffers gives their raw uint16
    bits; h2d of those bits into other pages restores them bitwise."""
    from dynamo_tpu_torch.llm.kvbm.transfer import (CopyStream,
                                                    from_host_array)

    dev = _card()
    rng = np.random.default_rng(8)
    shape = (4, 8, 10, 64, 128)            # [L, Hkv, pages, page, Dh]
    k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, torch.bfloat16) for _ in range(2))
    cs = CopyStream()
    src, dst = [7, 2, 5], [1, 3, 9]
    hk, hv = cs.d2h_pages(k, v, src)
    assert hk.dtype == np.uint16 and hk.shape == (3, 4, 8, 64, 128)
    want_k = k[:, :, src].permute(2, 0, 1, 3, 4).cpu()
    assert torch.equal(from_host_array(hk, torch.bfloat16).view(torch.int16),
                       want_k.view(torch.int16))
    k2, v2 = torch.zeros_like(k), torch.zeros_like(v)
    cs.h2d_pages(k2, v2, dst, hk, hv)
    torch.cuda.synchronize()
    for a, b in ((k2, k), (v2, v)):
        assert torch.equal(a[:, :, dst].view(torch.int16),
                           b[:, :, src].view(torch.int16))
    assert cs.d2h_bytes == cs.h2d_bytes == 2 * hk.nbytes


@pytest.mark.cuda
def test_eviction_offloads_the_old_bytes_before_the_overwriting_dispatch():
    """Stream ordering: request B's prefill leases (evicts) pages of A's
    cached prefix and its dispatch overwrites them; the host tier must
    still receive A's bytes, and a restore of A's prefix must put them
    back bitwise."""
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)
    from dynamo_tpu_torch.llm.tokens import compute_seq_hashes
    from dynamo_tpu_torch.models import llama

    _card()
    cfg = TorchEngineConfig(
        model=llama.preset("tiny-byte", head_dim=64), device="cuda",
        page_size=16, max_batch=1, max_context=128, prefill_chunk=64,
        decode_steps=4, num_pages=7, host_cache_blocks=8)
    core = EngineCore(cfg)

    def run(sid, toks):
        core.submit(sid, BackendInput(token_ids=toks, stop=StopConditions(
            max_tokens=3, ignore_eos=True)))
        got = []
        for _ in range(50):
            for so in core.step():
                got.append(so.token)
                if so.finish is not None:
                    return got
        raise AssertionError(f"{sid} did not finish")

    a = list(range(1, 65))                 # 4 full pages of 16
    first = run("a", a)
    hashes = compute_seq_hashes(a, 16)
    pages = [core.pool.blocks._by_hash[h] for h in hashes]
    before = {h: (core.k_pool[:, :, p].clone(), core.v_pool[:, :, p].clone())
              for h, p in zip(hashes, pages)}
    run("b", list(range(100, 164)))        # evicts and overwrites A's pages
    offloaded = [h for h in hashes if h in core.tiered]
    assert offloaded
    for h in offloaded:
        k, v = core.tiered.peek(h)
        for got, want in ((k, before[h][0]), (v, before[h][1])):
            assert np.array_equal(got, want.view(torch.uint16).cpu().numpy())
    # A again: its first three blocks come back from the host tier (the
    # fourth stays for the last prompt token's logits), bit for bit
    run("a2", a)
    assert core.last_prefix_hit == 48 and core.tiered.stats()["hits"] >= 2
    for h in hashes[:3]:
        p = core.pool.blocks._by_hash[h]
        assert torch.equal(core.k_pool[:, :, p].view(torch.int16),
                           before[h][0].view(torch.int16))
        assert torch.equal(core.v_pool[:, :, p].view(torch.int16),
                           before[h][1].view(torch.int16))
    assert len(first) == 3


# ---------------------------------------------------------------------------
# the engine on the card: construction check, tiny-byte, the chained window
# ---------------------------------------------------------------------------

def _tiny_core(**kw):
    from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
    from dynamo_tpu_torch.models import llama

    cfg = dict(model=llama.preset("tiny-byte"), device="cuda", page_size=64,
               max_batch=4, max_context=256, prefill_chunk=64,
               decode_steps=8)
    cfg.update(kw)
    return EngineCore(TorchEngineConfig(**cfg))


def _submit(core, sid, prompt, n):
    from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                       StopConditions)

    core.submit(sid, BackendInput(token_ids=prompt, stop=StopConditions(
        max_tokens=n, ignore_eos=True)))


@pytest.mark.cuda
def test_engine_serves_tiny_byte_at_head_dim_16():
    """The CLI's default model (tiny-byte, Dh=16, bf16) serves on the card
    through both kernels: every prefill dispatch and decode step launched
    them, once a layer."""
    _card()
    core = _tiny_core()
    assert core.cfg.model.head_dim == 16
    tatt.flash_attention.launches = tatt.paged_attention.launches = 0
    _submit(core, "a", list(range(1, 100)), 20)
    _submit(core, "b", list(range(50, 60)), 13)
    got = {"a": [], "b": []}
    for _ in range(100):
        for so in core.step():
            assert so.finish is None or so.finish.value == "length", so
            got[so.seq_id].append(so.token)
        if not core.has_work:
            break
    assert [len(got["a"]), len(got["b"])] == [20, 13]
    assert all(0 <= t < core.cfg.model.vocab_size for t in got["a"] + got["b"])
    L = core.cfg.model.num_layers
    assert tatt.flash_attention.launches == L * core.prefill_dispatches > 0
    assert tatt.paged_attention.launches == L * core.decode_steps_run > 0
    assert core.pool.free_pages == core.pool.num_pages - 1


@pytest.mark.cuda
@pytest.mark.parametrize("override", [{"dtype": torch.float32},
                                      {"head_dim": 80}])
def test_engine_construction_rejects_models_without_kernels(override):
    """A head dim or dtype the kernels lack raises at construction, before
    any request; there is no fallback to the plain path."""
    from dynamo_tpu_torch.models import llama

    _card()
    with pytest.raises(ValueError, match="no CUDA attention kernel"):
        _tiny_core(model=llama.preset("tiny-byte", **override))


@pytest.mark.cuda
def test_chained_decode_enqueue_does_not_sync():
    """A chained decode dispatch is enqueued with no host sync: every host
    input goes through pinned memory, the tokens come from the dispatch in
    flight, and the result copy waits on an event only at the fetch."""
    _card()
    core = _tiny_core()
    _submit(core, "a", list(range(1, 40)), 48)
    _submit(core, "b", list(range(60, 70)), 48)
    for _ in range(20):
        core.step()
        if len(core._inflight) == 1 and core._can_chain():
            break
    assert len(core._inflight) == 1
    n = core.decode_dispatches
    torch.cuda.set_sync_debug_mode("error")
    try:
        core._dispatch_decode()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert core.decode_dispatches == n + 1 and core._inflight[-1]["chained"]
    got = {"a": 0, "b": 0}
    for _ in range(40):
        for so in core.step():
            got[so.seq_id] += 1
        if not core.has_work:
            break
    assert got["a"] + got["b"] > 0 and not core.has_work
    assert core.pool.free_pages == core.pool.num_pages - 1
