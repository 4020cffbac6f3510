"""Where an image chat request's preprocessing runs, measured on the card.

Runs ``chip_smoke.vlm_phase`` (Gemma3-4B-it over HTTP: a burst of three
image requests and a text request, then requests alone) with the image
preprocessing (PNG decode, template, tokenization)

- ``pool1``: on the pipeline's one-worker executor, as served;
- ``default_pool``: on the loop's default thread pool (several at once);
- ``inline``: on the event loop itself,

each with the smoke's Paeth-filtered PNGs and with Sub-filtered ones (the
cheapest filter to undo), in turns (the order, then reversed), and prints
one JSON line a run: burst and alone TTFT, the 1200x900 PNG's decode
seconds, and whether the phase's checks passed.

    python scripts/vlm_preprocess_probe.py      # needs one CUDA card
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch.llm import _png, pipeline
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        print("vlm_preprocess_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    print(smi, flush=True)
    _build.build_all()
    pool, has_images, paeth = (pipeline._IMAGE_PREPROCESS,
                               pipeline.has_images, _png.encode)
    where = {"pool1": (pool, has_images),
             "default_pool": (None, has_images),
             "inline": (pool, lambda messages: False)}
    filters = {"paeth": paeth,
               "sub": lambda rgb: _png.encode_raw(rgb, 2, filters=(1,))}
    order = [(w, f) for f in filters for w in where]
    emit = cs.emit
    try:
        for w, f in order + order[::-1]:
            (pipeline._IMAGE_PREPROCESS, pipeline.has_images) = where[w]
            _png.encode = filters[f]
            row: dict = {}
            cs.emit = row.update
            try:
                cs.vlm_phase(torch, att, smi)
                result = "pass"
            except AssertionError as e:
                result = "failed: " + str(e)[:300]
            cs.emit = emit
            print(json.dumps({
                "preprocess": w, "png_filter": f, "result": result,
                "burst_ttft_s": row.get("burst_ttft_s"),
                "alone_ttft_s": row.get("alone_ttft_s"),
                "png_decode_1200x900_s": row.get(
                    "png_decode_1200x900_paeth_s"),
                "card": smi}), flush=True)
    finally:
        (pipeline._IMAGE_PREPROCESS, pipeline.has_images) = where["pool1"]
        _png.encode = paeth
        cs.emit = emit
    return 0


if __name__ == "__main__":
    sys.exit(main())
