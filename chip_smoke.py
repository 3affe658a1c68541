#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA card.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line:

* ``device``: ``torch.cuda`` must see a card (else the script exits 1 and
  prints no result); nvidia-smi's name and power limit.
* ``build``: compiles every ``deepspeed_tpu_torch/csrc/*.cu`` with nvcc, one
  process per source, all started together.
* ``kernel``: holds each kernel against its plain PyTorch version on the
  card, at the serving shape and at edge cases, and times the kernel, the
  plain version and one PyTorch library call that computes the same function.
* ``serve``: GPT-2 1.3B at full width and depth (random weights, seed 0)
  through ``init_inference``: ``forward`` on [4, 1024] ids through the flash
  kernel, checked against the einsum path on the same weights, then
  ``generate`` of 32 greedy tokens for 4 ragged prompts. The kernels' launch
  counts are set to 0 just before this phase and read just after it.
* ``profile``: the card's time by kernel in one traced forward and one
  traced generate (torch.profiler).
* ``small``: a small fp32 GPT on the card, whose greedy ``generate`` must
  equal an argmax rollout of the full forward, token for token.

Then the kernels line, nvidia-smi's line and, last, ``{"ok": true, ...}``.
A failed check raises, and the script exits nonzero. It imports neither jax
nor ``deepspeed_tpu``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# max-abs error allowed against the plain version, per input dtype: bf16 keeps
# ~3 significant digits and P is rounded to bf16 before P@V, so o may differ
# by a few 1e-3 on O(1) values; lse is an f32 sum on both sides
TOLERANCE = {"bfloat16": {"o": 2e-2, "lse": 1e-3},
             "float16": {"o": 5e-3, "lse": 1e-3},
             "float32": {"o": 1e-4, "lse": 1e-4}}

# flash (f32 scores) against einsum (bf16 scores) on the same 1.3B weights:
# the two paths round differently at every layer, so logits differ by bf16
# noise; top-1 agreement is held to 0.9 because random weights leave many
# near-ties among 50257 logits
SERVE_TOP1_MIN = 0.9
SERVE_MAX_ABS_LOGIT_DIFF = 1.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, reps=5):
    """Median host time of one call that ends in a device synchronise."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch

    # the plain versions are the references: keep f32 matmuls in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from deepspeed_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    built = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, info in built.items()}
    emit({"phase": "build", "seconds": seconds, "sources": build.sources(),
          "compiled": {n: i["seconds"] for n, i in built.items()},
          "ptxas": ptxas})


def _segments(b, t, gen, device):
    """Packed-batch segment ids: documents of random length, 1-based, with a
    0-padded tail."""
    import torch

    seg = torch.zeros((b, t), dtype=torch.int32)
    for row in range(b):
        pos, doc = 0, 1
        end = t - int(torch.randint(1, t // 8, (1,), generator=gen))
        while pos < end:
            n = int(torch.randint(8, t // 3, (1,), generator=gen))
            seg[row, pos:min(pos + n, end)] = doc
            pos, doc = pos + n, doc + 1
    return seg.to(device)


def attention_flops_bytes(b, t, h, d, causal, itemsize):
    """Operations and bytes one attention forward needs: 2 matmuls over the
    visible (query, key) pairs, q/k/v read once, o and lse written once."""
    pairs = b * (t * (t + 1) // 2 if causal else t * t)
    flops = 4 * pairs * h * d
    nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
    return flops, nbytes


def phase_kernel():
    """B1, the flash-attention forward, against its plain version."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # name, B, T, H, D, causal, dtype, packed segments
    cases = [
        ("serving_1p3b", 4, 1024, 16, 128, True, bf16, False),
        ("d64_full", 2, 512, 8, 64, False, bf16, False),
        ("ragged_t200", 2, 200, 16, 128, True, bf16, False),
        ("segments", 2, 384, 8, 128, True, bf16, True),
        ("fp16_ragged", 1, 333, 4, 128, True, f16, False),
        ("fp32", 1, 256, 4, 64, True, f32, False),
        ("fp32_full_segments", 1, 130, 2, 128, False, f32, True),
    ]
    serving = None
    for name, b, t, h, d, causal, dtype, packed in cases:
        # q, k, v as the model hands them over: views into one fused
        # [B, T, 3*H*D] projection, read through their strides
        qkv = torch.randn((b, t, 3 * h * d), generator=gen).to(dev, dtype)
        q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
        seg = _segments(b, t, gen, dev) if packed else None
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        segment_ids=seg)
        o_ref, lse_ref = fa.flash_attention_reference(
            q, k, v, causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        tol = TOLERANCE[str(dtype).split(".")[-1]]
        line = {"phase": "kernel", "kernel": "flash_attention_fwd",
                "case": name, "shape": [b, t, h, d], "causal": causal,
                "dtype": str(dtype), "segments": packed,
                "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
                "tol": tol}
        if not (o_err <= tol["o"] and lse_err <= tol["lse"]):
            emit(line)
            raise AssertionError(f"flash_attention_fwd {name}: o err {o_err}, "
                                 f"lse err {lse_err} over {tol}")
        if packed:
            # another segment's keys and values must not touch a row:
            # perturb one document and require the others bit-identical
            target = seg[0, t // 2].item()
            hit = (seg == target)[:, :, None]
            qkv2 = qkv.clone()
            noise = torch.randn(qkv2[..., h * d:].shape, generator=gen)
            qkv2[..., h * d:] += 5 * noise.to(dev, dtype) * hit
            q2, k2, v2 = (x.view(b, t, h, d)
                          for x in qkv2.split(h * d, dim=-1))
            o2, _ = fa.flash_attention_fwd(q2, k2, v2, causal=causal,
                                           segment_ids=seg)
            keep = ~hit[..., 0]
            line["isolated_bit_exact"] = bool(torch.equal(o2[keep], o[keep]))
            if not line["isolated_bit_exact"]:
                emit(line)
                raise AssertionError(f"{name}: cross-segment leakage")
        emit(line)
        if name == "serving_1p3b":
            serving = (q, k, v, o_err, causal)

    q, k, v, o_err, causal = serving
    b, t, h, d = q.shape
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                            causal=causal))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    flops, nbytes = attention_flops_bytes(b, t, h, d, causal,
                                          q.element_size())
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
             "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:53",
             "launches": None, "max_abs_err": o_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": library_ms}
    emit({"phase": "kernel", "kernel": "flash_attention_fwd",
          "case": "serving_1p3b", "timing": entry, "flops": flops,
          "bytes": nbytes, "tflops_per_s": flops / ms / 1e9})
    return [entry]


def phase_serve():
    """GPT-2 1.3B through init_inference, the port's serving path."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import (
        GPT, gpt2_config, num_params)
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    cfg = gpt2_config("gpt2-1.3b", use_flash_attention=True)
    t0 = time.perf_counter()
    engine = init_inference(GPT(cfg), dtype="bf16", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen)
    lengths = [37, 64, 100, 128]
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
    mask = torch.arange(128)[None, :] < torch.tensor(lengths)[:, None]
    prompts = prompts * mask

    fa.launches = 0
    logits = engine(ids)
    torch.cuda.synchronize()
    forward_launches = fa.launches
    toks = engine.generate(prompts, max_new_tokens=32, attention_mask=mask)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.launches}

    if forward_launches != cfg.n_layer:
        raise AssertionError(f"forward launched flash_attention_fwd "
                             f"{forward_launches} times, want {cfg.n_layer}")
    if tuple(logits.shape) != (4, 1024, cfg.vocab_size) or \
            logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits on the flash path")
    if tuple(toks.shape) != (4, 32) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(toks.shape)}, "
                             f"range [{toks.min()}, {toks.max()}]")

    einsum = init_inference(
        GPT(gpt2_config("gpt2-1.3b", use_flash_attention=False)),
        dtype="bf16", state_dict=engine.module.state_dict())
    logits_e = einsum(ids)
    diff = (logits - logits_e).abs().max().item()
    top1 = (logits.argmax(-1) == logits_e.argmax(-1)).float().mean().item()
    del logits_e, einsum

    forward_ms = wall_ms(lambda: engine(ids))
    fa.launches = 0
    gen1_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=1,
                                              attention_mask=mask), reps=3)
    gen32_ms = wall_ms(lambda: engine.generate(prompts, max_new_tokens=32,
                                               attention_mask=mask), reps=3)
    line = {"phase": "serve", "model": "gpt2-1.3b",
            "params": num_params(cfg), "dtype": "bf16", "init_s": init_s,
            "forward_shape": [4, 1024], "forward_launches": forward_launches,
            "launches": launches,
            "flash_vs_einsum_max_abs_logit_diff": diff,
            "flash_vs_einsum_top1_agreement": top1,
            "forward_ms": forward_ms,
            "forward_tokens_per_s": 4 * 1024 / forward_ms * 1e3,
            "prompt_lengths": lengths, "new_tokens": 32,
            "prefill_ms": gen1_ms,
            "decode_ms_per_token": (gen32_ms - gen1_ms) / 31,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    if not (top1 >= SERVE_TOP1_MIN and diff <= SERVE_MAX_ABS_LOGIT_DIFF):
        raise AssertionError(
            f"flash vs einsum logits: top-1 agreement {top1} (min "
            f"{SERVE_TOP1_MIN}), max abs diff {diff} (max "
            f"{SERVE_MAX_ABS_LOGIT_DIFF})")
    phase_profile(engine, ids, prompts, mask)
    return launches


def _trace(fn):
    """Run ``fn`` under torch.profiler; the card's kernel time by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms_ = (time.perf_counter() - t0) * 1e3
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            n += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms_, "device_ms": device_ms, "kernels": n,
            "device_busy_share": device_ms / wall_ms_,
            "top_ms": [[name[:90], ms] for name, ms in top]}, by_name


def phase_profile(engine, ids, prompts, mask):
    """Where the card's time goes in one traced forward and one traced
    8-token generate (tracing slows the host, so wall times here read high)."""
    fwd, by_name = _trace(lambda: engine(ids))
    flash_ms = sum(ms for name, ms in by_name.items()
                   if "fwd_mma_kernel" in name)
    fwd["flash_ms"] = flash_ms
    fwd["flash_share_of_device"] = (flash_ms / fwd["device_ms"]
                                    if fwd["device_ms"] else None)
    gen, _ = _trace(lambda: engine.generate(prompts, max_new_tokens=8,
                                            attention_mask=mask))
    emit({"phase": "profile", "forward_4x1024": fwd,
          "generate_4_prompts_8_tokens": gen})


def phase_small():
    """A small fp32 GPT on the card: cached greedy decode must equal an
    argmax rollout of the full forward."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=512, n_positions=256, n_embd=256, n_layer=2,
                    n_head=4, dtype=torch.float32, use_flash_attention=True)
    engine = init_inference(GPT(cfg), dtype="fp32", seed=3)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    toks = engine.generate(ids, max_new_tokens=8).cpu()
    cur, expect = ids, []
    for _ in range(8):
        nxt = engine(cur)[:, -1].argmax(-1).cpu()
        expect.append(nxt)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
    expect = torch.stack(expect, dim=1)
    same = bool(torch.equal(toks, expect))
    emit({"phase": "small", "tokens_identical_to_rollout": same})
    if not same:
        raise AssertionError(f"cached decode {toks.tolist()} != rollout "
                             f"{expect.tolist()}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    kernels = phase_kernel()
    launches = phase_serve()
    phase_small()
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} never ran on the main path")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
