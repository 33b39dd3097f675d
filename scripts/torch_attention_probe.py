"""Time the PyTorch/CUDA port's LM serving on one NVIDIA GPU, for a
parent-against-change comparison of two checkouts on one card.

    python scripts/torch_attention_probe.py --tag new [--timings]

h2o-danube-1.8b at full width and depth (random weights from seed 0),
``ServingEngine.generate`` with the cost model's slots, prompt 512, gen
32, after a warm-up, three times: prefill seconds and decode tokens/s,
each line tagged ``--tag``. With ``--timings`` it then runs
``chip_smoke.lm_timings`` (kernel, plain and library times).

It imports the ``repro_torch`` under ``./src`` of the working directory,
so running it from the root of another checkout measures that checkout:
for an A/B, run it from each tree in turns (parent, new, new, parent, ...)
in one run on one card. Needs CUDA; exits 2 without it.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd() / "src"))
sys.path.insert(1, str(Path.cwd()))


def probe_serve(tag: str, timings: bool) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    _build.build_all()
    cfg = get_config("h2o-danube-1.8b")
    dev = torch.device("cuda")
    slots = serve.serving_slots(cfg)
    model = build_model(cfg, attn_impl="chunked")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = serve.ServingEngine(model, params, max_len=512 + 32,
                                 batch_slots=slots, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (slots, 512)).astype(np.int32)
    engine.generate(prompts[:, :64], 2)                 # warm-up
    for rep in range(3):
        engine.stats = dict.fromkeys(engine.stats, 0)
        engine.generate(prompts, 32)
        st = engine.stats
        print(f"{tag} rep {rep}: prefill {st['prefill_s']:.4f} s, decode "
              f"{st['decode_s']:.4f} s = "
              f"{st['decode_tokens'] / st['decode_s']:.1f} tok/s",
              flush=True)
    if timings:
        del engine, params, model
        torch.cuda.empty_cache()
        import chip_smoke
        chip_smoke.lm_timings(dev, slots, 512, 32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--timings", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    probe_serve(args.tag, args.timings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
