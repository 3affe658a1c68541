"""How far the block-sparse routes' attention gradients lie apart, on one
card.

BERT-Large under ``chip_smoke.py``'s BigBird config at [1, 4096], random
weights from seed 0: one forward and backward (no optimizer step) through
each route from the same weights and batch, then the relative L2 distance
between the q, k and v rows of every layer's ``qkv`` weight gradient,
concatenated over the layers. Routes: "dense" (f32 scores and softmax),
"gather", "kernels" (B5, then the delta prologue, B6 and B7), and the
kernel route with the plain f32 versions in place of the kernels, once
with the kernels' delta = rowsum(o * do) from the rounded o
("ref_delta_from_o") and once with the exact softmax backward's delta =
rowsum(P * dP) ("ref_exact_delta"). In bf16 the kernel route's q and k rows
lie further from dense than gather's do; the reference routes show whether
that comes from the kernels or from the delta. The f32 pass (dense, gather,
kernels) shows the routes computing one function.

Run: ``python3 sparse_grad_spread.py`` on a machine with one CUDA card. It
prints one JSON line per dtype.
"""

import json
import math
import sys

import numpy as np
import torch

import chip_smoke
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.bert import BertForPreTraining, bert_config
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa


def ref_fwd(q, k, v, tables, *, block, causal=False, scale=None):
    return bsa.block_sparse_attention_reference(
        q, k, v, tables.layout, block=block, causal=causal, scale=scale)


def ref_bwd(q, k, v, o, lse, do, tables, *, block, causal=False, scale=None):
    return bsa.block_sparse_attention_backward_reference(
        q, k, v, o, lse, do.to(q.dtype), tables.layout, block=block,
        causal=causal, scale=scale)


def exact_bwd(q, k, v, o, lse, do, tables, *, block, causal=False, scale=None):
    """As ``ref_bwd`` but with the softmax backward's own delta,
    rowsum(P * dP), in place of rowsum(o * do)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    s, keep, qf, kf = bsa._scores(q, k, tables.layout, block, causal, scale)
    vf, dof = (x.transpose(1, 2).float() for x in (v, do.to(q.dtype)))
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    grads = (torch.matmul(ds, kf) * scale,
             torch.matmul(ds.transpose(-1, -2), qf) * scale,
             torch.matmul(p.transpose(-1, -2), dof))
    return tuple(x.transpose(1, 2).to(q.dtype) for x in grads)


KERNELS = (bsa.block_sparse_fwd, bsa.block_sparse_bwd)
ROUTES = {"dense": None, "gather": None, "kernels": KERNELS,
          "ref_delta_from_o": (ref_fwd, ref_bwd),
          "ref_exact_delta": (ref_fwd, exact_bwd)}


def spread(dtype, routes):
    cfg = bert_config("bert-large", dtype=dtype, scan_layers=True, remat=True,
                      remat_policy="full",
                      max_position_embeddings=chip_smoke.SPARSE_SEQ)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, size=(1, chip_smoke.SPARSE_SEQ))
    labels = np.where(rng.rand(1, chip_smoke.SPARSE_SEQ) < 0.15, ids, -100)
    batch = {"input_ids": ids.astype(np.int64), "labels": labels.astype(np.int64)}
    config = dict(chip_smoke.BERT_SPARSE_CONFIG)
    if dtype == torch.float32:
        config.pop("bf16")
    grads, weights = {}, None
    for route in routes:
        fns = ROUTES[route]
        bsa.block_sparse_fwd, bsa.block_sparse_bwd = fns or KERNELS
        kernel = "pallas" if fns else route
        kw = ({"seed": 0} if weights is None else
              {"model_parameters": {k: v.clone() for k, v in weights.items()}})
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=BertForPreTraining(cfg), config=dict(
                config, sparse_attention=dict(chip_smoke.BIGBIRD_BLOCK,
                                              kernel=kernel)), **kw)
        if weights is None:
            weights = {k: v.clone() for k, v in engine.module.state_dict().items()}
        grads[route] = chip_smoke.qkv_grads(engine.module, batch)
        del engine
        torch.cuda.empty_cache()
    bsa.block_sparse_fwd, bsa.block_sparse_bwd = KERNELS
    line = {"dtype": str(dtype).split(".")[-1], "qkv_grad_rel_l2": {}}
    for route in routes:
        for ref in ("dense", "kernels"):
            if route != ref and not (route == "dense" and ref == "kernels"):
                line["qkv_grad_rel_l2"][f"{route}_vs_{ref}"] = {
                    n: float((grads[route][n] - g).norm() / g.norm())
                    for n, g in grads[ref].items()}
    return line


def main():
    if not torch.cuda.is_available():
        print("sparse_grad_spread: no CUDA device visible", file=sys.stderr)
        return 1
    print(json.dumps(spread(torch.bfloat16, list(ROUTES))), flush=True)
    print(json.dumps(spread(torch.float32, ["dense", "gather", "kernels"])),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
