"""The GPT's training options and the block-sparse route under tensor
parallelism, against the JAX package on one device and the port in one
process.

Two gloo ranks (``test_torch_zero.start_ranks``, this file's worker, one
spawn), each building only its shard of a small LLaMA-shaped GPT (4 query
and 2 KV heads, an untied vocab-parallel head) or a GPT-2-shaped one (a
tied vocab-parallel ``wte``) from the JAX weights, f32 on the CPU:

* **attention-probability dropout** (the fault ROADMAP C.6 named): under
  tp each rank's probability mask is its heads' slice of one draw over
  all heads and the global batch, so the ranks' masks differ and each is
  its heads' part of the one-process engine's mask at the same seed; the
  whole-activation masks are the one-process engine's on both ranks; 3
  training steps at dropout 0.1 match the one-process engine's;
* **the block-sparse route** (``"kernel": "pallas"``: the plain versions of
  B5-B7 on CPU tensors) under a sliding window and a per-head BigBird
  layout (``different_layout_per_head``, grouped-query): logits, loss and
  every gradient against the flax model on one device (its "gather"
  route); the ring KV cache at tp 2: a prefill that wraps the 32-slot
  ring and decode steps against the forward's logits, and the engine's
  greedy tokens against the one-process engine's;
* **the fused head + CE over a vocab-parallel head** (chunks of 8 tokens):
  loss and every gradient against JAX's ``fused_linear_cross_entropy``
  model on one device and against the port's unfused vocab-parallel head.

Bounds are ``test_torch_tensor_parallel.py``'s (f32, orders of sums):
logits to atol 1e-4, the loss to rtol 1e-5, every gradient to 1e-5 of its
largest entry, training losses and grad norms to rtol 1e-5 and the update
to 1e-3 in relative L2; masks and greedy tokens exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_tensor_parallel as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(tp.LLAMA, n_positions=256)
GPT2 = dict(tp.GPT2, n_positions=256)
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3, "kernel": "pallas"}
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1,
           "attention": "unidirectional", "different_layout_per_head": True,
           "kernel": "pallas"}
LAYOUTS = {"window": WINDOW, "bigbird": BIGBIRD}
T = 64
DROPOUT = 0.1
FUSED_CHUNK = 8
# a prefill of 5 blocks (the ring holds 2), then a block of decode steps
PREFILL, DECODE = 80, 16


def sparse_fields(fields, layout, port=True):
    """``fields`` with ``layout`` as the config's ``sparse_attention`` (the
    port's config object, or JAX's on its "gather" route)."""
    if port:
        from deepspeed_tpu_torch.ops.sparse_attention import \
            sparse_attention_utils as utils
        block = dict(layout)
    else:
        from deepspeed_tpu.ops.sparse_attention import \
            sparse_attention_utils as utils
        block = dict(layout, kernel="gather")
    return dict(fields, sparse_attention=utils.get_sparse_attention_config(
        block, fields["n_head"]))


def train_config(micro, mesh):
    config = tp.ds_config(micro, mesh)
    return config if mesh else {k: v for k, v in config.items()
                                if k != "tpu"}


def steps(rows=2):
    return [[b] for b in tp.train_batches(rows, seed=31)]


# ---------------------------------------------------------------------------
# the ranks (the dropout and ring jobs also run as the one-process reference)
# ---------------------------------------------------------------------------
def masks_run(fields, sd, config, batches, seed=0):
    """An engine at dropout ``DROPOUT`` (einsum attention): the masks its
    first step draws, in order, then its losses, grad norms and whole
    parameters over ``batches``."""
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.runtime.activation_checkpointing as ac
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    real, masks = ac.bernoulli_mask, []

    def recording(*args, **kw):
        mask = real(*args, **kw)
        masks.append(mask.clone())
        return mask

    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**fields, dropout=DROPOUT,
                                    dtype=torch.float32)),
        config=config, device="cpu", seed=seed,
        model_parameters={k: v.clone() for k, v in sd.items()})[0]
    out = {"losses": [], "norms": []}
    for i, step in enumerate(batches):
        ac.bernoulli_mask = recording if i == 0 else real
        try:
            out["losses"].append(float(engine.train_batch(iter(step))))
        finally:
            ac.bernoulli_mask = real
        out["norms"].append(engine.get_global_grad_norm())
    out["masks"], out["params"] = masks, engine.params
    return out


def ring_run(fields, sd, ids, sizes):
    """A ring-cached engine (the window layout): the prefill's last logits
    and each decode step's against the block-aligned forward's at the same
    positions, and greedy tokens."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    engine = deepspeed_tpu_torch.init_inference(
        tlm.GPT(tlm.GPTConfig(**sparse_fields(fields, WINDOW),
                              dtype=torch.float32)),
        dtype="fp32", device="cpu", state_dict=sd, **sizes)
    ids = torch.from_numpy(ids).long()
    mask = torch.ones((ids.shape[0], PREFILL), dtype=torch.bool)
    with torch.inference_mode():
        logits, cache = engine._chunked_prefill(ids[:, :PREFILL], mask)
        decoded = [logits]
        for j in range(PREFILL, PREFILL + DECODE):
            logits, _ = engine.module(ids[:, j:j + 1], decode=True,
                                      cache=cache)
            cache.lengths += 1
            decoded.append(logits[:, -1])
        forward = engine.forward(ids[:, :PREFILL + DECODE])[
            :, PREFILL - 1:]
    return {"decoded": torch.stack(decoded, dim=1), "forward": forward,
            "ring_heads": cache.key[0].shape[2], "ring_slots":
            cache.key[0].shape[1],
            "tokens": engine.generate(ids[:, :PREFILL], max_new_tokens=6)}


def _job(job, rank):
    if job["kind"] == "model":
        return tp._model_job(job, rank)
    if job["kind"] == "masks":
        return masks_run(job["fields"], job["sd"], job["config"],
                         job["steps"])
    return ring_run(job["fields"], job["sd"], job["ids"], {"mp_size": 2})


def _worker(argv):
    spec, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import reset_default_topology

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=tp.GROUP_TIMEOUT_S),
                          device_type="cpu")
    results = {}
    for job in torch.load(spec, weights_only=False):
        reset_default_topology()
        results[job["name"]] = _job(job, rank)
    torch.save(results, out)
    comm.destroy_distributed()
    return 0


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_zero import start_ranks

    engines = {"llama": tp.jax_engine(LLAMA), "gpt2": tp.jax_engine(GPT2)}
    sd = {n: tp.port_weights(e, f) for (n, e), f in
          zip(engines.items(), (LLAMA, GPT2))}
    ids = tp.ids_of((2, PREFILL + DECODE), 3)
    mesh = {"tp": 2, "dp": 1}
    jobs = [dict(name="masks", kind="masks", fields=LLAMA, sd=sd["llama"],
                 config=train_config(2, mesh), steps=steps()),
            dict(name="ring", kind="ring", fields=LLAMA, sd=sd["llama"],
                 ids=ids)]
    jobs += [dict(name=f"sparse_{n}", kind="model",
                  fields=sparse_fields(LLAMA, layout), sd=sd["llama"],
                  ids=ids[:, :T], mesh=mesh)
             for n, layout in LAYOUTS.items()]
    jobs += [dict(name=f"{fused}_{n}", kind="model",
                  fields=dict(f, fused_head_ce=FUSED_CHUNK if fused ==
                              "fused" else False),
                  sd=sd[n], ids=ids[:, :tp.SEQ], mesh=mesh)
             for n, f in (("llama", LLAMA), ("gpt2", GPT2))
             for fused in ("fused", "unfused")]
    ranks = start_ranks(jobs, tmp_path_factory.mktemp("tp_options"), 2,
                        worker=__file__)
    ref = {"masks": masks_run(LLAMA, sd["llama"], train_config(2, {}),
                              steps()),
           "ring": ring_run(LLAMA, sd["llama"], ids, {})}
    for n, layout in LAYOUTS.items():
        ref[f"sparse_{n}"] = tp.jax_loss_and_grads(
            sparse_fields(LLAMA, layout, port=False),
            engines["llama"].params, ids[:, :T])
    for n, f in (("llama", LLAMA), ("gpt2", GPT2)):
        ref[f"fused_{n}"] = tp.jax_loss_and_grads(
            dict(f, fused_head_ce=FUSED_CHUNK), engines[n].params,
            ids[:, :tp.SEQ])
    return dict(ranks=ranks, ref=ref, sd=sd)


# -- C.6: attention-probability dropout under tp -------------------------------
def test_probability_masks_are_each_ranks_heads_of_one_draw(runs):
    """The 4-d masks (the probabilities', ``[B, H/tp, T, T]``) are each
    rank's heads of the one-process engine's ``[B, H, T, T]`` mask at the
    same seed, so they differ between the ranks; the other masks are the
    one-process engine's on both ranks."""
    want = runs["ref"]["masks"]["masks"]
    ranks = [r["masks"]["masks"] for r in runs["ranks"]]
    heads = LLAMA["n_head"] // 2
    probs = 0
    for i, w in enumerate(want):
        for rank, got in enumerate(ranks):
            if w.dim() == 4:
                assert torch.equal(
                    got[i], w[:, rank * heads:(rank + 1) * heads]), i
            else:
                assert torch.equal(got[i], w), i
        if w.dim() == 4:
            probs += 1
            assert not torch.equal(ranks[0][i], ranks[1][i])
    # one probability mask a layer, and the embedding's, attention
    # output's and MLP's masks
    assert probs == LLAMA["n_layer"]
    assert len(want) == 1 + 3 * LLAMA["n_layer"]


def test_dropout_training_at_tp2_matches_one_process(runs):
    for r in runs["ranks"]:
        tp.assert_run(r["masks"], runs["ref"]["masks"], runs["sd"]["llama"])


# -- the block-sparse route and the ring cache under tp ------------------------
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sparse_route_matches_jax(runs, layout):
    want_logits, want_loss, want_grads = runs["ref"][f"sparse_{layout}"]
    for r in runs["ranks"]:
        got = r[f"sparse_{layout}"]
        np.testing.assert_allclose(got["logits"].numpy(), want_logits,
                                   atol=tp.ATOL, rtol=0)
        np.testing.assert_allclose(got["loss"], want_loss, rtol=tp.LOSS_RTOL)
        tp.assert_grads(got["grads"], want_grads)


def test_ring_decode_at_tp2_matches_forward_and_one_process(runs):
    one = runs["ref"]["ring"]
    for r in runs["ranks"]:
        got = r["ring"]
        # the rank's KV head in a 32-slot ring (the prefill wrapped it)
        assert got["ring_heads"] == 1 and got["ring_slots"] == 32
        np.testing.assert_allclose(got["decoded"].numpy(),
                                   got["forward"].numpy(), atol=tp.ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got["decoded"].numpy(),
                                   one["decoded"].numpy(), atol=tp.ATOL,
                                   rtol=0)
        assert torch.equal(got["tokens"], one["tokens"])


# -- the fused head over a vocab-parallel head ---------------------------------
@pytest.mark.parametrize("model", ["llama", "gpt2"])
def test_fused_head_matches_jax_and_the_unfused_head(runs, model):
    want_logits, want_loss, want_grads = runs["ref"][f"fused_{model}"]
    for r in runs["ranks"]:
        fused, unfused = r[f"fused_{model}"], r[f"unfused_{model}"]
        np.testing.assert_allclose(fused["loss"], want_loss,
                                   rtol=tp.LOSS_RTOL)
        tp.assert_grads(fused["grads"], want_grads)
        np.testing.assert_allclose(fused["loss"], unfused["loss"],
                                   rtol=tp.LOSS_RTOL)
        tp.assert_grads(fused["grads"], unfused["grads"])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
