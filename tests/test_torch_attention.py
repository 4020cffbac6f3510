"""The torch port's attention (``dynamo_tpu_torch.ops.attention``) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_attention_kernels.py`` runs them.

On the CPU each wrapper runs its plain torch version; inputs are float32 so
the comparison checks the algorithm (masking, windows, softcap, scale, GQA
grouping, fully masked rows), not bf16 rounding. Tolerance: 2e-5 absolute —
f32 sums in another order. The CUDA kernels themselves are checked against
the same plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.attention import (_paged_attention_tpu, flash_attention,
                                      paged_attention)
from dynamo_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

ATOL = 2e-5


def _flash_inputs(seed, B, T, S, Hq, Hkv, Dh, padded=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, Dh), np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh), np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh), np.float32)
    ctx = S // 2 - T // 2
    q_pos = np.broadcast_to(np.arange(ctx, ctx + T, dtype=np.int32),
                            (B, T)).copy()
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_valid = k_pos < ctx + T
    if padded:
        # the last lane's last rows are padding: position 0 with key 0
        # invalid, so they see nothing and must come out 0
        q_pos[-1, T // 2:] = 0
        k_valid[-1, 0] = False
    return q, k, v, q_pos, k_pos, k_valid


def _run_flash_both(args, **kw):
    q, k, v, q_pos, k_pos, k_valid = args
    want = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), jnp.asarray(k_valid), interpret=True, **kw))
    got = tatt.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        torch.from_numpy(k_valid), **kw).numpy()
    return got, want


@pytest.mark.parametrize("B,T,S,Hq,Hkv,Dh", [
    (1, 32, 128, 4, 2, 16),   # GQA group 2
    (2, 32, 64, 8, 8, 32),    # MHA (group 1)
    (1, 16, 64, 4, 1, 16),    # group 4
])
def test_flash_plain_matches_pallas(B, T, S, Hq, Hkv, Dh):
    got, want = _run_flash_both(_flash_inputs(0, B, T, S, Hq, Hkv, Dh))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,softcap,scale", [
    (24, 30.0, 1.0 / math.sqrt(24.0)),    # sliding window, softcap, scale
])
def test_flash_plain_window_softcap_scale(window, softcap, scale):
    args = _flash_inputs(7, 2, 32, 128, 4, 2, 16)
    got, want = _run_flash_both(args, window=window, softcap=softcap,
                                scale=scale)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,softcap", [
    (None, None),
    (5, 30.0),                   # a window far narrower than any tile
])
def test_flash_plain_matches_pallas_kernel_head_dim(window, softcap):
    """The CUDA kernel's own head dim (64) and a GQA group of 8, with T and
    S that fill none of its 64-row / 64-key tiles, and padded rows."""
    args = _flash_inputs(17, 2, 24, 40, 8, 1, 64, padded=True)
    got, want = _run_flash_both(args, window=window, softcap=softcap)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[-1, 12:] == 0.0)


def test_flash_plain_fully_padded_rows_are_zero():
    args = _flash_inputs(3, 2, 16, 64, 4, 2, 16, padded=True)
    got, want = _run_flash_both(args, softcap=50.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[-1, 8:] == 0.0)


def _paged_inputs(seed, B, Hq, Hkv, Dh, page, P, lengths):
    rng = np.random.default_rng(seed)
    n_pages = B * P + 1
    q = rng.standard_normal((B, Hq, Dh), np.float32)
    kp = rng.standard_normal((Hkv, n_pages, page, Dh), np.float32)
    vp = rng.standard_normal((Hkv, n_pages, page, Dh), np.float32)
    # a shuffled page assignment (page 0 stays the scratch page)
    pt = (rng.permutation(n_pages - 1)[:B * P] + 1).reshape(B, P)
    return (q, kp, vp, pt.astype(np.int32),
            np.asarray(lengths, np.int32))


def _torch_paged(args, **kw):
    q, kp, vp, pt, ln = (torch.from_numpy(a) for a in args)
    return tatt.paged_attention(q, kp, vp, pt, ln, **kw).numpy()


@pytest.mark.parametrize("window,softcap,scale", [
    (None, None, None),
    (12, 30.0, 1.0 / math.sqrt(24.0)),
    (1000, 50.0, None),          # window wider than any context
])
def test_paged_plain_matches_pallas(window, softcap, scale):
    B, Hq, Hkv, Dh, page, P = 4, 4, 2, 16, 8, 4
    # ragged lengths: 1 token, exactly one page, a ragged tail, full table
    args = _paged_inputs(11, B, Hq, Hkv, Dh, page, P, [1, 8, 13, 32])
    kw = dict(window=window, softcap=softcap, scale=scale)
    want = np.asarray(paged_attention(*(jnp.asarray(a) for a in args),
                                      interpret=True, **kw))
    np.testing.assert_allclose(_torch_paged(args, **kw), want, atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("window,softcap,ppb", [
    (None, None, 2),
    (12, 30.0, 3),               # ppb=3 pads the page table
])
def test_paged_plain_matches_pallas_dma_variant(window, softcap, ppb):
    B, Hq, Hkv, Dh, page, P = 3, 4, 2, 16, 8, 4
    args = _paged_inputs(13, B, Hq, Hkv, Dh, page, P, [5, 12, 32])
    q, kp, vp, pt, ln = args
    want = np.asarray(_paged_attention_tpu(
        jnp.asarray(q).reshape(B, Hkv, Hq // Hkv, Dh), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(ln),
        pages_per_block=ppb, softcap=softcap, window=window,
        interpret=True)).reshape(B, Hq, Dh)
    got = _torch_paged(args, softcap=softcap, window=window)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cpu_wrappers_never_touch_launch_counters():
    f0 = tatt.flash_attention.launches
    p0 = tatt.paged_attention.launches
    tatt.flash_attention(*(torch.from_numpy(a) for a in
                           _flash_inputs(1, 1, 16, 64, 4, 2, 16)))
    _torch_paged(_paged_inputs(2, 2, 4, 2, 16, 8, 2, [3, 16]))
    assert tatt.flash_attention.launches == f0
    assert tatt.paged_attention.launches == p0


def test_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other non-CUDA
    device raises instead of silently computing elsewhere."""
    q = torch.zeros((1, 4, 2, 16), device="meta")
    k = torch.zeros((1, 8, 2, 16), device="meta")
    pos = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.flash_attention(q, k, k, pos, pos, pos.bool())
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.paged_attention(q[:, 0], k[0].transpose(0, 1)[:, None], k[0]
                             .transpose(0, 1)[:, None], pos, pos[:, 0])
