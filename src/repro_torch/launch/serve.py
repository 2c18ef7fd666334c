"""Serving entry point: batched prefill + decode with fixed-shape caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --batch 4 --prompt-len 32 --gen 32 [--device cpu]

Mirrors ``repro.launch.serve`` on one card (its ``--mesh`` is not
ported): prefill once, take the first token greedily from its logits,
then ``gen`` one-token decode steps, each sampled greedily (temperature
0) or from ``softmax(logits / temperature)`` with an explicit
``torch.Generator``.  Runs on the CUDA card unless given
``device="cpu"`` / ``--device cpu``; without a card it raises.  On the
card every prefill launches one kernel per layer, the flash-attention
kernel (K3) for a dense model, the fused selective-scan kernel (K2's
redesign for the Mamba layer, JAX's ``_fused_chunk_scan``) for
Falcon-Mamba (``--arch falcon-mamba-7b``), K2
for each RG-LRU layer and K3 for each local-attention layer of
RecurrentGemma (``--arch recurrentgemma-9b``), K3 for each layer of
a GQA MoE model (``--arch kimi-k2-1t-a32b``) or of Qwen2-VL (``--arch
qwen2-vl-72b``, whose prompt starts with the stub patch embeddings), and
K3 for each encoder layer (non-causal) and each decoder layer of Whisper
(``--arch whisper-small``, over the stub frame embeddings; its
cross-attention is plain PyTorch); an MLA model (``--arch
deepseek-v2-lite-16b``) launches none, its prefill attention is plain
PyTorch as in the JAX package.  Decode launches no kernel, and the
stats count all three.  Computes in
the weights' dtype (``Model.init(..., dtype=torch.bfloat16)`` serves in
bf16, K3's tensor-core design); ``main`` serves fp32 with full-fp32
matrix products (TF32 off).  Under ``torch.profiler`` each call is a
``serve.call`` span (``repro_torch.common.trace``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common import trace
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.linear_scan.kernel import (linear_scan_kernel,
                                                    selective_scan_kernel)
from repro_torch.models import Model, build_model, make_batch


# the kernels each family's prefill launches on the card (an MLA model's
# none)
_FAMILY_KERNELS = {"dense": ("flash_attention",), "ssm": ("selective_scan",),
                   "hybrid": ("linear_scan", "flash_attention"),
                   "moe": ("flash_attention",), "vlm": ("flash_attention",),
                   "audio": ("flash_attention",)}


def family_kernels(cfg) -> Tuple[str, ...]:
    return () if cfg.use_mla else _FAMILY_KERNELS[cfg.family]


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, -1)
        tok = torch.multinomial(probs, 1, generator=generator)
    else:
        tok = torch.argmax(logits, -1, keepdim=True)
    return tok.to(torch.int32)


def serve(model: Model, params, tokens, gen: int, *,
          stubs: Optional[Dict[str, torch.Tensor]] = None,
          temperature: float = 0.0,
          generator: Optional[torch.Generator] = None, device=None
          ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Prefill ``tokens`` (B, S) and decode ``gen`` tokens.

    ``stubs`` holds the batch's stub embeddings the family reads beside
    the tokens, ``frames`` (audio) or ``patches`` (vlm); they are moved
    to ``device`` in the weights' dtype (the JAX code would promote bf16
    weights against fp32 frames; the port does not).
    ``params`` must lie on ``device`` (``None``: the CUDA card);
    ``temperature > 0`` needs a ``generator`` on that device.  The cache
    holds the S + gen positions the run fills.  Returns the (B,
    gen + 1) generated token ids (the prefill's greedy token, then one
    per decode step) on the CPU, and the stats: ``prefill_s``,
    ``decode_s``, ``tokens_per_s`` (decoded tokens over ``decode_s``),
    ``ttft_s`` (until the first token is known), ``k3_launches`` (K3
    launches in the prefill), ``k3_decode_launches``, ``k2_launches``
    and ``k2_decode_launches`` (K2's, the same way) and
    ``finite_logits`` (every step's logits were finite)."""
    with trace.span("serve.call", root=True):
        dev = resolve_device(device)
        if temperature > 0 and generator is None:
            raise ValueError(
                "temperature sampling needs an explicit generator")
        tokens = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
        wdt = params["embed"]["table"].dtype
        batch = {"tokens": tokens, **{name: t.to(dev, wdt)
                                      for name, t in (stubs or {}).items()}}
        B, S = tokens.shape
        on_card = dev.type == "cuda"
        if on_card:  # build the family's kernels outside the timed region
            for name in family_kernels(model.cfg):
                build.load(name)

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        sync()
        k3_0 = flash_attention_kernel.launches
        k2_0 = linear_scan_kernel.launches
        ss_0 = selective_scan_kernel.launches
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len=S + gen)
        sync()
        t_prefill = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        # the first token is greedy, as in JAX
        nxt = _sample(logits, 0.0, None)
        sync()
        ttft = time.perf_counter() - t0
        k3_prefill = flash_attention_kernel.launches - k3_0
        k2_prefill = linear_scan_kernel.launches - k2_0
        ss_prefill = selective_scan_kernel.launches - ss_0

        out = [nxt]
        t1 = time.perf_counter()
        for i in range(gen):
            idx = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, cache, nxt, idx)
            finite &= torch.isfinite(logits).all()
            nxt = _sample(logits, temperature, generator)
            out.append(nxt)
        sync()
        t_decode = time.perf_counter() - t1
        stats = {
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": gen * B / max(t_decode, 1e-9), "ttft_s": ttft,
            "k3_launches": k3_prefill,
            "k3_decode_launches": (flash_attention_kernel.launches - k3_0
                                   - k3_prefill),
            "k2_launches": k2_prefill,
            "k2_decode_launches": (linear_scan_kernel.launches - k2_0
                                   - k2_prefill),
            "selective_scan_launches": ss_prefill,
            "selective_scan_decode_launches": (selective_scan_kernel.launches
                                               - ss_0 - ss_prefill),
            "finite_logits": bool(finite),
        }
        return torch.cat(out, dim=1).cpu(), stats


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed,
                       device=dev)
    tokens = batch.pop("tokens")
    del batch["labels"]
    gen, stats = serve(
        model, params, tokens, args.gen, stubs=batch,
        temperature=args.temperature,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    print("generated token ids (first request):", gen[0][:16].tolist(),
          "...")
    rec = {**stats, "batch": args.batch, "arch": cfg.name,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
