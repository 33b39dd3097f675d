"""Serving launcher: prefill + greedy decode over a fixed slot pool.

Port of ``src/repro/launch/serve.py``. Runs on the card unless told
otherwise; there is no CPU fallback:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --smoke --device cpu --requests 8 --prompt-len 32 --gen 16

Weights are random, drawn from seed 0 on the device (as the reference
draws them from ``PRNGKey(0)``). The slot count comes from the cost model
(Eq. 11) with the ``"cuda"`` profile where the reference uses ``"tpu"``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.pipeline import OpProfile, choose_batch_size
from repro_torch.pipeline.backend import resolve_device
from repro_torch.training import make_serve_step


def _same_device(t: torch.Tensor, dev: torch.device) -> bool:
    if t.device.type != dev.type:
        return False
    return dev.index is None or t.device.index == dev.index


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class ServingEngine:
    """Batched prefill+decode over a fixed-size slot pool (the serving
    side of the paper's window-function batch inference).

    ``stats`` sums, over :meth:`generate` calls, the host seconds of
    prefill and of decode (each ending in a device synchronize) and the
    tokens each produced."""

    def __init__(self, model, params, *, max_len: int, batch_slots: int,
                 device="cuda"):
        self.device = resolve_device(device)
        off = [tuple(t.shape) for t in _leaves(params)
               if not _same_device(t, self.device)]
        if off:
            raise ValueError(f"ServingEngine on {self.device}: {len(off)} "
                             f"params lie elsewhere (first {off[0]})")
        self.model = model
        self.params = params
        self.max_len = max_len
        self.slots = batch_slots
        self.serve_step = make_serve_step(model)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_tokens": 0, "decode_tokens": 0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, gen_tokens: int) -> np.ndarray:
        """prompts: [B, S] -> generated ids [B, gen_tokens] (greedy)."""
        B = prompts.shape[0]
        outs = []
        for lo in range(0, B, self.slots):
            chunk = torch.as_tensor(np.asarray(prompts[lo:lo + self.slots]),
                                    dtype=torch.long, device=self.device)
            self._sync()
            t0 = time.perf_counter()
            logits, state = self.model.prefill(self.params, chunk,
                                               max_len=self.max_len)
            tok = logits[:, -1:, :].argmax(dim=-1)
            self._sync()
            t1 = time.perf_counter()
            gen = [tok]
            for _ in range(gen_tokens - 1):
                tok, state = self.serve_step(self.params, state, tok)
                gen.append(tok)
            out = torch.cat(gen, dim=1).cpu()
            t2 = time.perf_counter()
            self.stats["prefill_s"] += t1 - t0
            self.stats["decode_s"] += t2 - t1
            self.stats["prefill_tokens"] += chunk.numel()
            self.stats["decode_tokens"] += chunk.shape[0] * (gen_tokens - 1)
            outs.append(out)
        return torch.cat(outs, dim=0).numpy().astype(np.int32)


def serving_slots(cfg) -> int:
    """Eq. 11 batch slots for the decode step on the card's profile."""
    n = cfg.param_count()
    prof = OpProfile(flops_per_row=2.0 * n, bytes_per_row=cfg.d_model * 2,
                     model_bytes=n * 2)
    return choose_batch_size(prof, "cuda", mem_cap_bytes=8e9,
                             candidates=(1, 2, 4, 8, 16, 32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit(
            f"{cfg.arch_id} is an encoder-decoder model: this launcher serves "
            "decoder-only LMs. Serve it through "
            "repro_torch.training.make_prefill_step / make_serve_step "
            "(or EncDecModel.prefill with a max_len, then make_serve_step)")
    device = resolve_device(args.device)
    model = build_model(cfg, attn_impl="naive" if args.smoke else "chunked")
    params = model.init(torch.Generator(device=device).manual_seed(0))

    slots = serving_slots(cfg)
    print(f"serving {cfg.arch_id} on {device}: batch slots={slots} "
          "(cost model)")

    engine = ServingEngine(model, params, max_len=args.prompt_len + args.gen,
                           batch_slots=slots, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = engine.generate(prompts, args.gen)
    dt = time.time() - t0
    total = args.requests * args.gen
    st = engine.stats
    print(f"generated {out.shape} in {dt:.2f}s ({total / dt:.1f} tok/s; "
          f"prefill {st['prefill_s']:.3f}s, decode "
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tok/s); "
          f"sample: {out[0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
