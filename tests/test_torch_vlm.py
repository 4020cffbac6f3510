"""The torch port's Gemma3 vision-language serving, held against the JAX
package, and its PIL-free image decoding held against PIL.

- ``models/siglip.py``: the tower's ``forward`` and the projector's
  ``project`` against the JAX functions (f32, within 1e-5); HF tensors map
  as the JAX ``params_from_hf`` maps them; the nested HF config maps as the
  JAX ``from_hf_config`` does (both spellings of the image token id).
- ``engine/multimodal.py``: ``image_spans``, ``validate_mm_prompt``,
  ``chunk_end`` and ``soft_token_rows`` give the JAX functions' outputs on
  seeded inputs; ``resize_bilinear`` is bit for bit PIL's ``BILINEAR``
  resize, and ``normalize_image`` the JAX one (which resizes with PIL).
- ``llm/_png.py``: every colour type and bit depth it serves, plain and
  Adam7, with all five filter types, decodes bit for bit as PIL's
  ``convert("RGB")``; other formats raise ``ProtocolError`` naming them.
- The engine: greedy streams of an image request, a two-image request and
  a text-only request on ``tiny-gemma3-vlm`` (f32, served together) equal
  the JAX engine's (``attn_impl="xla"``) with the same weights and tower;
  image waves run the dense path and never split a span; the sealed block
  hashes equal the JAX engine's, under the frontend's ``kv_salt`` and under
  the pixel digest; the rejections carry the JAX messages; a checkpoint's
  tower loads, and one without a tower is refused.

The JAX engines take numpy-drawn weights (their own ``jax.random`` init
compiles one program per leaf shape, seconds on the CPU); their serving
path is untouched.
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import multimodal as jmm
from dynamo_tpu.engine.engine import EngineCore as JaxCore, JaxEngineConfig
from dynamo_tpu.llm.protocols.common import (BackendInput as JBI,
                                             StopConditions as JSC)
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import siglip as jsig
from dynamo_tpu_torch.engine import multimodal as tmm
from dynamo_tpu_torch.engine.engine import EngineCore, TorchEngineConfig
from dynamo_tpu_torch.engine.loader import save_llama_params
from dynamo_tpu_torch.llm import _png
from dynamo_tpu_torch.llm import safetensors_io as sio
from dynamo_tpu_torch.llm.preprocessor import _decode_data_url, image_kv_salt
from dynamo_tpu_torch.llm.protocols.common import (BackendInput,
                                                   StopConditions)
from dynamo_tpu_torch.llm.protocols.openai import ProtocolError
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import siglip as tsig

torch.set_num_threads(2)
CPU = torch.device("cpu")
IMG, MM_TOK = 250, 4                     # tiny-gemma3-vlm
VCFG = dict(tl.PRESETS["tiny-gemma3-vlm"]["vision"])
ENGINE = dict(page_size=8, max_batch=4, max_context=128, prefill_chunk=8,
              decode_steps=4)
MAX_TOKENS = 6


def np_weights(shapes, rng, ones=("ln1", "ln2", "final_norm")):
    """Leaves drawn with numpy, f32: normal / sqrt(leading dim), the named
    ones ones."""
    return {k: np_weights(v, rng, ones) if isinstance(v, dict) else (
        np.ones(v, np.float32) if k in ones else
        (rng.standard_normal(v) / np.sqrt(v[0])).astype(np.float32))
        for k, v in shapes.items()}


def tower_weights(rng):
    """A random tower tree with a trained tower's scales: matrices normal /
    sqrt(fan-in), biases and norm weights a tenth of a unit off zero and
    one (so parity would catch a dropped or misplaced one). The JAX init's
    own scale, normal / sqrt(layers), saturates the softmax, where f32
    rounding alone moves both towers ~3e-5 off an f64 forward."""
    cfg = tsig.SiglipVisionConfig.from_hf_config(VCFG)
    tree = np_weights(tsig.param_shapes(cfg), rng, ones=())
    for sub in (tree, tree["layers"]):
        for k, v in sub.items():
            if not isinstance(v, np.ndarray):
                continue
            if k in ("patch_w", "pos_embed", "wq", "wk", "wv", "wo", "fc1",
                     "fc2"):
                fan_in = v.shape[-2] if v.ndim == 3 else v.shape[0]
                sub[k] = (rng.standard_normal(v.shape)
                          / np.sqrt(fan_in)).astype(np.float32)
            else:
                sub[k] = (0.1 * rng.standard_normal(v.shape)
                          + k.endswith("_w")).astype(np.float32)
    proj = {"norm": (0.1 * rng.standard_normal(32)).astype(np.float32),
            "proj": (rng.standard_normal((32, 64)) / np.sqrt(32)).astype(
                np.float32)}
    return tree, proj


def image(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


# the engine run: span straddling the 8-token chunk boundary, two images
# in one request, a text-only request beside them
IMAGES = {"one": [image(1, 40, 50)], "two": [image(2, 70, 60),
                                             image(3, 56, 56)]}
PROMPTS = {"one": [3] * 6 + [IMG] * MM_TOK + [8, 9, 10, 11],
           "two": [5] + [IMG] * MM_TOK + [3] + [IMG] * MM_TOK + [9],
           "text": [5, 6, 7, 8, 9]}
# the frontend's salt on "one"; "two" salts by the normalized pixels
SALTS = {"one": image_kv_salt(0, IMAGES["one"])}


def _serve(core, bi, sc, mkhook=None):
    sealed = {}
    core.pool.on_block_sealed = lambda sid, b, p, l: sealed.setdefault(
        sid, []).append(b.sequence_hash)
    for sid, toks in PROMPTS.items():
        core.submit(sid, bi(token_ids=toks, images=IMAGES.get(sid),
                            kv_salt=SALTS.get(sid, 0),
                            stop=sc(max_tokens=MAX_TOKENS, ignore_eos=True)))
    got = {sid: [] for sid in PROMPTS}
    for _ in range(200):
        for so in core.step():
            assert so.error is None, so.error
            got[so.seq_id].append(so.token)
        if not core.has_work:
            break
    return got, sealed


@pytest.fixture(scope="module")
def jax_vlm():
    """The JAX engine on tiny-gemma3-vlm (f32): its streams, sealed block
    hashes, and weights as numpy."""
    rng = np.random.default_rng(0)
    tree = np_weights(tl.param_shapes(tl.preset("tiny-gemma3-vlm")), rng)
    tower, proj = tower_weights(rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "init_params", lambda cfg, key: tree)
        mp.setattr(jsig, "init_params", lambda cfg, key: tower)
        mp.setattr(jsig, "init_projector_params", lambda c, d, key: proj)
        core = JaxCore(JaxEngineConfig(
            model=jl.preset("tiny-gemma3-vlm", dtype=jnp.float32),
            attn_impl="xla", **ENGINE))
        got, sealed = _serve(core, JBI, JSC)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return dict(core=core, got=got, sealed=sealed,
                params=to_np(core.params), tower=to_np(core.vision_params),
                proj=to_np(core.proj_params))


def _torch_core(ref, **kw):
    m = tl.preset("tiny-gemma3-vlm", dtype=torch.float32)
    vcfg = tsig.SiglipVisionConfig.from_hf_config(m.vision,
                                                  dtype=torch.float32)
    cfg = TorchEngineConfig(model=m, device="cpu", **{**ENGINE, **kw})
    return EngineCore(cfg, tl.params_from_jax(ref["params"], m, CPU),
                      vision_params=(
                          tsig.params_from_jax(ref["tower"], vcfg, CPU),
                          tsig.projector_from_jax(ref["proj"], vcfg, 64,
                                                  CPU)))


def test_vlm_greedy_streams_and_block_hashes_match_jax_engine(
        jax_vlm, monkeypatch):
    core = _torch_core(jax_vlm)
    waves = []      # (attn_impl, tokens, last index, q_span) per prefill
    forward = tl.forward

    def recorded(*args, **kw):
        spans = kw.get("attn_spans")
        waves.append((kw["attn_impl"], args[2].numpy(),
                      kw["logits_idx"].numpy(),
                      None if spans is None else spans[0].numpy()))
        return forward(*args, **kw)

    monkeypatch.setattr(tl, "forward", recorded)
    got, sealed = _serve(core, BackendInput, StopConditions)
    assert got == jax_vlm["got"]
    assert all(len(v) == MAX_TOKENS for v in got.values())
    # published block hashes: the frontend's salt and the pixel digest
    assert sealed == jax_vlm["sealed"]
    assert set(sealed) == set(PROMPTS)
    # image waves ran dense with their spans, text waves flash; no chunk
    # split a span
    image_waves = [w for w in waves if w[3] is not None]
    assert [w[0] for w in waves] == [
        "dense" if w[3] is not None else "flash" for w in waves]
    assert core.image_waves == len(image_waves) >= 1
    assert core.prefill_dispatches == len(waves)
    assert core.images_encoded == 3
    for _, _, _, q_span in image_waves:
        for row in q_span:
            for g in set(row[row > 0].tolist()):
                assert int((row == g).sum()) == MM_TOK
    # the straddling span moved the first chunk of "one" back to 6 tokens
    assert any((toks[:6] == 3).all() and last == 5
               for _, rows, lasts, _ in waves
               for toks, last in zip(rows, lasts))
    assert core.pool.free_pages == core.pool.num_pages - 1


def test_vlm_same_image_hits_and_other_image_misses(jax_vlm):
    core = _torch_core(jax_vlm)
    prompt = PROMPTS["one"] + [12] * 8
    hits = []
    for seed in (1, 1, 2):
        im = [image(seed, 40, 50)]
        core.submit(str(seed) + str(len(hits)), BackendInput(
            token_ids=prompt, images=im, kv_salt=image_kv_salt(0, im),
            stop=StopConditions(max_tokens=2, ignore_eos=True)))
        while core.has_work:
            core.step()
        hits.append(core.last_prefix_hit)
    assert hits[0] == 0 and hits[1] > 0 and hits[2] == 0


def test_vlm_rejections_carry_the_jax_messages(jax_vlm):
    """Wrong image count, wrong span length, an image on a text model."""
    bad = {"count": (PROMPTS["one"], IMAGES["two"] + IMAGES["one"]),
           "length": ([5, IMG, IMG, 6], IMAGES["one"])}
    cores = {"jax": jax_vlm["core"], "torch": _torch_core(jax_vlm)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "init_params", lambda cfg, key: np_weights(
            tl.param_shapes(tl.preset("tiny-gemma3")),
            np.random.default_rng(1)))
        text = {"jax": JaxCore(JaxEngineConfig(
                    model=jl.preset("tiny-gemma3", dtype=jnp.float32),
                    attn_impl="xla", **ENGINE)),
                "torch": EngineCore(TorchEngineConfig(
                    model=tl.preset("tiny-gemma3", dtype=torch.float32),
                    device="cpu", **ENGINE))}
    errs = {}
    for side, bi, sc in (("jax", JBI, JSC),
                         ("torch", BackendInput, StopConditions)):
        todo = [(cores[side], k, *v) for k, v in bad.items()]
        todo.append((text[side], "text", PROMPTS["one"], IMAGES["one"]))
        for core, k, toks, ims in todo:
            core.submit(k, bi(token_ids=toks, images=ims,
                              stop=sc(max_tokens=2)))
            outs = core.step()
            assert [o.seq_id for o in outs] == [k] and not core.has_work
            errs[side, k] = outs[0].error
    for k in ("count", "length", "text"):
        assert errs["torch", k] == errs["jax", k]
    assert "expects exactly" in errs["torch", "length"]
    assert "no vision tower" in errs["torch", "text"]


def test_forward_refuses_spans_on_the_flash_path():
    m = tl.preset("tiny-gemma3-vlm", dtype=torch.float32)
    p = tl.init_params(m, torch.Generator().manual_seed(0), CPU)
    z = torch.zeros((1, 1), dtype=torch.int32)
    pool = torch.zeros((6, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="attn_impl='dense' only"):
        tl.forward(p, m, z, z, pool, pool, z, z, z, z.bool(),
                   attn_impl="flash", attn_spans=(z, z))


# ---------------------------------------------------------------------------
# the tower and the projector
# ---------------------------------------------------------------------------

def test_siglip_forward_and_project_match_jax():
    tower, proj = tower_weights(np.random.default_rng(3))
    jcfg = jsig.SiglipVisionConfig.from_hf_config(VCFG, dtype=jnp.float32)
    tcfg = tsig.SiglipVisionConfig.from_hf_config(VCFG, dtype=torch.float32)
    px = np.random.default_rng(4).standard_normal((2, 3, 56, 56)).astype(
        np.float32)
    jt = jax.tree.map(jnp.asarray, tower)
    want = jsig.forward(jt, jcfg, jnp.asarray(px))
    got = tsig.forward(tsig.params_from_jax(tower, tcfg, CPU), tcfg,
                       torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    wp = jsig.project(jax.tree.map(jnp.asarray, proj), jcfg, want, MM_TOK,
                      rms_eps=1e-6)
    gp = tsig.project(tsig.projector_from_jax(proj, tcfg, 64, CPU), tcfg,
                      got, MM_TOK, rms_eps=1e-6)
    assert gp.shape == (2, MM_TOK, 64)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-5,
                               rtol=1e-5)
    # the port's seeded init has the JAX tree's leaves and shapes
    ti = tsig.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jsig.init_params(jcfg, jax.random.PRNGKey(0))))
    assert jax.tree.map(lambda t: tuple(t.shape), ti,
                        is_leaf=lambda t: isinstance(t, torch.Tensor)) \
        == shapes


def _hf_vision_tensors(rng, prefix):
    """HF-layout Gemma3 vision tower and projector tensors."""
    D, F_, C, ps = 32, 48, 3, 14
    out = {prefix + "vision_tower.vision_model.embeddings.patch_embedding."
           "weight": rng.standard_normal((D, C, ps, ps)),
           prefix + "vision_tower.vision_model.embeddings.patch_embedding."
           "bias": rng.standard_normal(D),
           prefix + "vision_tower.vision_model.embeddings."
           "position_embedding.weight": rng.standard_normal((16, D)),
           prefix + "vision_tower.vision_model.post_layernorm.weight":
               rng.standard_normal(D),
           prefix + "vision_tower.vision_model.post_layernorm.bias":
               rng.standard_normal(D),
           prefix + "multi_modal_projector.mm_soft_emb_norm.weight":
               rng.standard_normal(D),
           prefix + "multi_modal_projector.mm_input_projection_weight":
               rng.standard_normal((D, 64))}
    for i in range(2):
        lay = f"{prefix}vision_tower.vision_model.encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            out[lay + n + ".weight"] = rng.standard_normal(D)
            out[lay + n + ".bias"] = rng.standard_normal(D)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[lay + f"self_attn.{n}.weight"] = rng.standard_normal((D, D))
            out[lay + f"self_attn.{n}.bias"] = rng.standard_normal(D)
        out[lay + "mlp.fc1.weight"] = rng.standard_normal((F_, D))
        out[lay + "mlp.fc1.bias"] = rng.standard_normal(F_)
        out[lay + "mlp.fc2.weight"] = rng.standard_normal((D, F_))
        out[lay + "mlp.fc2.bias"] = rng.standard_normal(D)
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_checkpoint_tower_loads_as_the_jax_mapping_and_missing_refused(
        tmp_path):
    m = tl.preset("tiny-gemma3-vlm", dtype=torch.float32)
    text = tl.init_params(m, torch.Generator().manual_seed(0), CPU)
    vt = _hf_vision_tensors(np.random.default_rng(5), "model.")
    d = tmp_path / "vlm"
    save_llama_params(str(d), text, m)
    sio.save_file(vt, str(d / "vision.safetensors"))
    core = EngineCore(TorchEngineConfig(model=m, device="cpu",
                                        params_path=str(d), **ENGINE))
    jcfg = jsig.SiglipVisionConfig.from_hf_config(VCFG, dtype=jnp.float32)
    stripped = {k[len("model."):]: v for k, v in vt.items()}
    want = jax.tree.map(np.asarray, (jsig.params_from_hf(stripped, jcfg),
                                     jsig.projector_from_hf(stripped, jcfg)))
    got = jax.tree.map(lambda t: t.numpy(),
                       (core.vision_params, core.proj_params),
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    jax.tree.map(np.testing.assert_array_equal, got, want)
    bare = tmp_path / "bare"
    save_llama_params(str(bare), text, m)
    with pytest.raises(ValueError, match="declares a vision tower"):
        EngineCore(TorchEngineConfig(model=m, device="cpu",
                                     params_path=str(bare), **ENGINE))


@pytest.mark.parametrize("spelling", ["image_token_id", "image_token_index"])
def test_nested_hf_config_maps_as_jax(spelling):
    """google/gemma-3-4b-it's sparse config maps field for field as the
    JAX package maps it, but for the tied head: the port applies
    Gemma3TextConfig's default (tied), the JAX package maps it untied
    (ROADMAP Queue 3 item 10); the result is the gemma3-4b preset."""
    hf = {"architectures": ["Gemma3ForConditionalGeneration"],
          "mm_tokens_per_image": 256, spelling: 262144,
          "text_config": {"model_type": "gemma3_text", "hidden_size": 2560,
                          "intermediate_size": 10240, "num_hidden_layers": 34,
                          "rope_scaling": {"rope_type": "linear",
                                           "factor": 8.0},
                          "sliding_window": 1024},
          "vision_config": {"hidden_size": 1152, "num_hidden_layers": 27,
                            "num_attention_heads": 16,
                            "intermediate_size": 4304, "image_size": 896,
                            "patch_size": 14}}
    j = jl.LlamaConfig.from_hf_config(hf).__dict__
    t = tl.LlamaConfig.from_hf_config(hf).__dict__
    skip = ("dtype", "tie_embeddings")
    assert {k: v for k, v in t.items() if k not in skip} \
        == {k: v for k, v in j.items() if k not in skip}
    assert t["tie_embeddings"] and not j["tie_embeddings"]
    assert t["image_token_id"] == 262144 and t["vision"]["num_hidden_layers"] \
        == 27
    preset = tl.preset("gemma3-4b").__dict__
    assert all(t[k] == v for k, v in preset.items()
               if k not in ("vision", "image_token_id"))
    with pytest.raises(ValueError, match="must nest"):
        tl.LlamaConfig.from_hf_config(
            {"architectures": ["Gemma3ForConditionalGeneration"]})


# ---------------------------------------------------------------------------
# host-side prompt assembly
# ---------------------------------------------------------------------------

def _seeded_prompts(n=12):
    rng = np.random.default_rng(7)
    for _ in range(n):
        toks = []
        for _ in range(rng.integers(0, 4)):
            toks += list(rng.integers(0, 9, rng.integers(0, 5)))
            toks += [IMG] * int(rng.choice([MM_TOK, MM_TOK, 3, 5]))
        toks += list(rng.integers(0, 9, rng.integers(1, 4)))
        yield toks, rng


def test_image_spans_match_jax():
    for toks, _ in _seeded_prompts():
        np.testing.assert_array_equal(tmm.image_spans(toks, IMG),
                                      jmm.image_spans(toks, IMG))


def test_validate_mm_prompt_matches_jax():
    for toks, rng in _seeded_prompts():
        spans = jmm.image_spans(toks, IMG)
        for n_img in range(4):
            for chunk in (2, MM_TOK, 16):
                assert tmm.validate_mm_prompt(spans, n_img, MM_TOK, chunk) \
                    == jmm.validate_mm_prompt(spans, n_img, MM_TOK, chunk)


def test_chunk_end_matches_jax():
    for toks, _ in _seeded_prompts():
        spans = jmm.image_spans(toks, IMG)
        for start in range(len(toks)):
            for max_count in (1, 3, MM_TOK, 6, 8):
                try:
                    want = jmm.chunk_end(spans, start, max_count)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        tmm.chunk_end(spans, start, max_count)
                    continue
                assert tmm.chunk_end(spans, start, max_count) == want


def test_soft_token_rows_match_jax():
    for toks, rng in _seeded_prompts():
        spans = jmm.image_spans(toks, IMG)
        n = int(spans.max())
        soft = rng.standard_normal((n, MM_TOK, 5)).astype(np.float32)
        for start in range(len(toks)):
            for count in (1, 4, len(toks)):
                count = min(count, len(toks) - start)
                if n == 0 or any(int((spans == g).sum()) != MM_TOK
                                 for g in range(1, n + 1)):
                    continue
                w = jmm.soft_token_rows(spans, soft, start, count)
                g = tmm.soft_token_rows(spans, soft, start, count)
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1], w[1])


# ---------------------------------------------------------------------------
# the resize and the PNG decoder, against PIL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,size", [((56, 56), 56), ((40, 40), 56),
                                     ((100, 100), 56), ((900, 1200), 896),
                                     ((480, 640), 896), ((13, 71), 56)])
def test_resize_is_pil_bilinear_bit_for_bit(hw, size):
    Image = pytest.importorskip("PIL.Image")
    a = image(hw[0] + hw[1], *hw)
    want = np.asarray(Image.fromarray(a).resize((size, size),
                                                Image.BILINEAR))
    np.testing.assert_array_equal(tmm.resize_bilinear(a, size, size), want)
    np.testing.assert_array_equal(tmm.normalize_image(a, size),
                                  jmm.normalize_image(a, size))


# (colour type, bit depth) served, and a tRNS chunk for each that has one
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("kind", PNG_KINDS,
                         ids=[f"ct{c}-{b}bit" for c, b in PNG_KINDS])
def test_png_decodes_as_pil(kind):
    Image = pytest.importorskip("PIL.Image")
    ct, bits = kind
    rng = np.random.default_rng(ct * 16 + bits)
    for interlace in (False, True):
        for h, w in ((1, 1), (9, 13), (33, 17)):
            pal = trns = None
            if ct == 3:
                n = int(rng.integers(1, 2 ** bits + 1))
                pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
                s = rng.integers(0, n, (h, w, 1))
                trns = bytes(rng.integers(0, 256, n).astype(np.uint8))
            else:
                s = rng.integers(0, 2 ** bits, (h, w, _png._CHANNELS[ct]))
                if ct in (0, 2):
                    trns = bytes(2 * (1 if ct == 0 else 3))
            raw = _png.encode_raw(s.astype(np.uint8), ct, bits, pal,
                                  interlace, filters=(0, 1, 2, 3, 4),
                                  trns=trns)
            want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
            got = _png.decode(raw)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, want)


def test_png_saved_by_pil_and_the_data_url_path():
    Image = pytest.importorskip("PIL.Image")
    a = image(9, 37, 41)
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        bio = io.BytesIO()
        Image.fromarray(a).convert(mode).save(bio, "PNG")
        want = np.asarray(Image.open(io.BytesIO(bio.getvalue()))
                          .convert("RGB"))
        np.testing.assert_array_equal(_png.decode(bio.getvalue()), want)
    url = "data:image/png;base64," + base64.b64encode(
        _png.encode(a)).decode()
    np.testing.assert_array_equal(_decode_data_url(url), a)


def test_image_chat_preprocesses_off_the_event_loop(monkeypatch):
    """An image request's decode runs on a worker thread: the loop keeps
    ticking through it. A text request's preprocessing stays inline."""
    import asyncio
    import time

    from dynamo_tpu_torch.llm.engines import EchoCoreEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.pipeline import OpenAIChatEngine
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.engine import Context

    engine = OpenAIChatEngine(ModelDeploymentCard.synthetic(),
                              EchoCoreEngine())

    def slow(req):
        time.sleep(0.2)
        raise ProtocolError("stop here")

    monkeypatch.setattr(engine.preprocessor, "preprocess_chat", slow)
    url = "data:image/png;base64," + base64.b64encode(
        _png.encode(image(5, 8, 8))).decode()

    async def ticks_during(content):
        ticks = 0

        async def ticker():
            nonlocal ticks
            while True:
                ticks += 1
                await asyncio.sleep(0.01)

        task = asyncio.create_task(ticker())
        await asyncio.sleep(0)
        req = ChatCompletionRequest.from_dict({
            "model": "echo",
            "messages": [{"role": "user", "content": content}]})
        with pytest.raises(ProtocolError, match="stop here"):
            async for _ in engine.generate(req, Context()):
                pass
        n = ticks
        task.cancel()
        return n

    assert asyncio.run(ticks_during(
        [{"type": "text", "text": "hi"},
         {"type": "image_url", "image_url": {"url": url}}])) >= 8
    assert asyncio.run(ticks_during("hi")) <= 1


def test_other_formats_and_broken_pngs_raise_protocol_error():
    Image = pytest.importorskip("PIL.Image")
    a = image(4, 16, 16)
    for fmt in ("JPEG", "GIF", "BMP"):
        bio = io.BytesIO()
        Image.fromarray(a).save(bio, fmt)
        with pytest.raises(ProtocolError, match=f"cannot decode a {fmt}"):
            _decode_data_url("data:image/x;base64,"
                             + base64.b64encode(bio.getvalue()).decode())
    bio = io.BytesIO()
    Image.fromarray((a[:, :, 0].astype(np.uint16) * 257)).save(bio, "PNG")
    with pytest.raises(ProtocolError, match="16 bits"):
        _png.decode(bio.getvalue())
    raw = _png.encode(a)
    with pytest.raises(ProtocolError, match="CRC"):
        _png.decode(raw[:40] + bytes([raw[40] ^ 1]) + raw[41:])
    with pytest.raises(ProtocolError):
        _png.decode(raw[:-20])
    # an IHDR past PIL's pixel limit, and data inflating past the image:
    # neither allocates what the request claims
    import struct
    import zlib
    big = _png.SIGNATURE + _png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 20000, 20000, 8, 2, 0, 0, 0)) + _png._chunk(
        b"IEND", b"")
    with pytest.raises(ProtocolError, match="exceeds the limit"):
        _png.decode(big)
    for w, h in ((4097, 4097), (_png.MAX_SIDE + 1, 1)):
        tall = _png.SIGNATURE + _png._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + _png._chunk(b"IEND", b"")
        with pytest.raises(ProtocolError, match="exceeds the limit"):
            _png.decode(tall)
    bomb = raw.split(b"IDAT")[0][:-4] + _png._chunk(
        b"IDAT", zlib.compress(bytes(16 << 20))) + _png._chunk(b"IEND", b"")
    np.testing.assert_array_equal(_png.decode(bomb), np.zeros_like(a))
    # a palette index past the PLTE entries: PIL's result is not
    # reproduced, so it is refused
    over = _png.encode_raw(np.full((2, 2, 1), 3, np.uint8), 3, 8,
                           np.zeros((2, 3), np.uint8))
    with pytest.raises(ProtocolError, match="PLTE"):
        _png.decode(over)
