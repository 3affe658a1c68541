"""Expert parallelism (the ``ep`` mesh axis) against the JAX package's
single-device runs and the port's own one-process engine.

A narrow Mixtral-shaped GPT (8 gated experts, top-2, the LLaMA trunk) at
capacity factors that drop no token (4 = E / 2 for top-2, 8 = E for top-1:
every expert may take every token) and, where JAX is the reference, with the load-balancing
loss off: under ep each rank routes its own rows (capacity and ``l_aux``
per rank, as reference DeepSpeed), where JAX routes the global batch, and
the two agree exactly when nothing is dropped and the aux loss is off.

2 gloo ranks (``test_torch_tensor_parallel.py``'s harness, one spawn):

* serving at ep 2 (every rank holds the rows; each runs its 4 experts and
  an all-gather over ep combines them) at batch 2 and batch 1 against
  JAX's one-device engine, greedy tokens too;
* the training route (rows split over ep, the dispatch all-to-alled)
  forward and backward on the rank's rows against the flax model on all
  rows: each rank's expert gradients are exactly its experts' slice of
  JAX's (never mixed across ranks), the other leaves' summed over ep;
* 3 training steps at ep 2: top-2 (the engine's gating noise) against the
  one-process engine at the global micro batch (one noise draw, sliced by
  rank), and top-1 without noise against the one-process engine at gas 2
  and against JAX's engine; its per-expert tag loads on one process.

4 ranks, tp 2 x ep 2: one forward and backward against the flax model (tp
inside each expert's hidden dimension).

Bounds as ``test_torch_tensor_parallel.py``'s (f32, orders of sums).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_tensor_parallel as tp  # noqa: E402

MIXTRAL = dict(tp.LLAMA, moe_num_experts=8, moe_top_k=2,
               moe_gated_experts=True, moe_capacity_factor=4.0,
               moe_eval_capacity_factor=4.0, moe_aux_loss_coef=0.0)
# the deterministic routing JAX's engine can be held to (no gating draw);
# top-1 drops no token at a capacity factor of E
TOP1 = dict(MIXTRAL, moe_top_k=1, moe_use_rts=False, moe_capacity_factor=8.0,
            moe_eval_capacity_factor=8.0)
ROWS = 4


def _sum_ranks(results, name, ranks, key="grads"):
    return {k: sum(results[r][name][key][k] for r in ranks)
            for k in results[ranks[0]][name][key]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    ids = tp.ids_of((ROWS, tp.SEQ), 11)
    engines = {"mixtral": tp.jax_engine(MIXTRAL), "top1": tp.jax_engine(TOP1)}
    sd = {"mixtral": tp.port_weights(engines["mixtral"], MIXTRAL),
          "top1": tp.port_weights(engines["top1"], TOP1)}
    steps = [[b] for b in tp.train_batches(2, seed=21)]
    tag_dir = str(tmp_path_factory.mktemp("ep_tag"))
    two = [dict(name="serve", kind="serve", fields=MIXTRAL,
                sd=sd["mixtral"], ids=ids[:2], dtype="fp32",
                sizes={"ep_size": 2}),
           dict(name="serve_b1", kind="serve", fields=MIXTRAL,
                sd=sd["mixtral"], ids=ids[:1], dtype="fp32",
                sizes={"ep_size": 2}),
           # each rank's rows, the loss scaled to its share of the mean
           dict(name="route", kind="model", fields=MIXTRAL,
                sd=sd["mixtral"], ids=ids, mesh={"ep": 2, "dp": 1},
                rows_split=True, loss_scale=0.5),
           dict(name="train_top2", kind="train", fields=MIXTRAL,
                sd=sd["mixtral"], steps=steps,
                config=tp.ds_config(1, {"ep": 2, "dp": 1})),
           dict(name="train_top1", kind="train", fields=TOP1,
                sd=sd["top1"], steps=steps,
                config=tp.ds_config(1, {"ep": 2, "dp": 1}), save=tag_dir)]
    four = [dict(name="route", kind="model", fields=MIXTRAL,
                 sd=sd["mixtral"], ids=ids, mesh={"tp": 2, "ep": 2, "dp": 1},
                 rows_split=True, loss_scale=0.5)]
    two = tp.spawn(two, 2, tmp_path_factory.mktemp("ep2"))
    four = tp.spawn(four, 4, tmp_path_factory.mktemp("tp2ep2"))

    ref = {"route": tp.jax_loss_and_grads(MIXTRAL, engines["mixtral"].params,
                                          ids)}
    for b in (2, 1):
        x = jnp.asarray(ids[:b], jnp.int32)
        ref[f"logits_b{b}"] = np.asarray(engines["mixtral"](x))
    # greedy rows are independent (no token is dropped): batch 1's tokens
    # are batch 2's first row
    ref["tokens_b2"] = np.asarray(engines["mixtral"].generate(
        jnp.asarray(ids[:2, :8], jnp.int32), max_new_tokens=tp.NEW_TOKENS))
    ref["tokens_b1"] = ref["tokens_b2"][:1]
    ref["jax_top1"] = tp.jax_train(TOP1, engines["top1"].params, steps)
    # the port without a group: top-2 at the global micro batch, top-1 at
    # gas 2 (each rank's row a micro batch)
    ref["one_top2"] = one_process(MIXTRAL, sd["mixtral"], steps, micro=2)
    ref["one_top1"] = one_process(
        TOP1, sd["top1"],
        [[{k: v[r:r + 1] for k, v in s[0].items()} for r in range(2)]
         for s in steps], micro=1, gas=2)
    return dict(two=two, four=four, ref=ref, sd=sd, ids=ids,
                tag_dir=tag_dir)


def one_process(fields, sd, steps, micro, gas=1):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    config = {k: v for k, v in tp.ds_config(micro, {}).items() if k != "tpu"}
    config["gradient_accumulation_steps"] = gas
    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**fields, dtype=torch.float32)),
        config=config, device="cpu",
        model_parameters={k: v.clone() for k, v in sd.items()})[0]
    out = {"losses": [], "norms": []}
    for step in steps:
        out["losses"].append(float(engine.train_batch(iter(step))))
        out["norms"].append(engine.get_global_grad_norm())
    out["params"] = engine.params
    return out


@pytest.mark.parametrize("batch", [2, 1])
def test_serving_at_ep2_matches_jax(batch, runs):
    name = "serve" if batch == 2 else "serve_b1"
    for r in runs["two"]:
        got = r[name]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   runs["ref"][f"logits_b{batch}"],
                                   atol=tp.ATOL, rtol=0)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      runs["ref"][f"tokens_b{batch}"])


@pytest.mark.parametrize("world", [2, 4])
def test_training_route_matches_jax(world, runs):
    """The rows split over ep (tp 2 inside each expert at 4 ranks): the
    rank's logits are JAX's for its rows; expert gradients gathered whole
    are JAX's, every other leaf's summed over the ep ranks."""
    results = runs["two"] if world == 2 else runs["four"]
    want_logits, want_loss, want_grads = runs["ref"]["route"]
    per_ep = 1 if world == 2 else 2          # tp ranks of an ep coordinate
    n = ROWS // 2
    for rank, r in enumerate(results):
        e = rank // per_ep
        np.testing.assert_allclose(r["route"]["logits"].numpy(),
                                   want_logits[e * n:(e + 1) * n],
                                   atol=tp.ATOL, rtol=0)
    summed = _sum_ranks(results, "route", [0, per_ep])
    losses = [results[0]["route"]["loss"], results[per_ep]["route"]["loss"]]
    np.testing.assert_allclose(np.mean(losses), want_loss, rtol=tp.LOSS_RTOL)
    got = {k: (results[0]["route"]["grads"][k] if ".experts." in k
               else summed[k]) for k in summed}
    tp.assert_grads(got, want_grads)


def test_expert_gradients_stay_on_their_rank(runs):
    """Each rank's own expert gradients (before any gather) are its four
    experts' slice of JAX's, bit for bit apart from the order of sums, and
    the other rank's slice differs: no exchange mixes them."""
    want = runs["ref"]["route"][2]
    for rank, r in enumerate(runs["two"]):
        local = r["route"]["local_grads"]
        names = [k for k in local if ".experts." in k]
        assert names
        for k in names:
            mine = want[k][4 * rank:4 * (rank + 1)]
            other = want[k][4 * (1 - rank):4 * (2 - rank)]
            scale = float(want[k].abs().max())
            assert float((local[k] - mine).abs().max()) <= \
                tp.GRAD_RTOL * scale + 1e-9, k
            assert not torch.allclose(local[k], other), k


def test_top2_training_matches_the_one_process_engine(runs):
    for r in runs["two"]:
        tp.assert_run(r["train_top2"], runs["ref"]["one_top2"],
                      runs["sd"]["mixtral"])


@pytest.mark.parametrize("ref", ["one_top1", "jax_top1"])
def test_top1_training_matches_gas2_and_jax(ref, runs):
    for r in runs["two"]:
        tp.assert_run(r["train_top1"], runs["ref"][ref], runs["sd"]["top1"])


def test_per_expert_tag_at_ep2_loads_at_ep1(runs):
    import deepspeed_tpu_torch
    from deepspeed_tpu.runtime.checkpoint_manifest import verify_tag_dir
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    saved = runs["two"][0]["train_top1"]["params"]  # the ranks have ended
    tag = os.path.join(runs["tag_dir"], f"global_step{tp.STEPS}")
    assert verify_tag_dir(tag) == []
    for e in range(TOP1["moe_num_experts"]):
        for kind in ("model", "optim"):
            assert os.path.exists(os.path.join(
                tag, f"expert_{e}_mp_rank_00_{kind}_states.pt"))
    config = {k: v for k, v in tp.ds_config(2, {}).items() if k != "tpu"}
    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**TOP1, dtype=torch.float32)),
        config=config, device="cpu")[0]
    engine.load_checkpoint(runs["tag_dir"])
    for k, v in engine.params.items():
        assert torch.equal(v, saved[k]), k
    assert engine.optimizer.count == tp.STEPS
