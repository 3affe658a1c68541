"""Tensor parallelism (the ``tp`` mesh axis) against the JAX package's
single-device runs on the same weights.

The JAX package runs ``tp`` as GSPMD shardings of one program (its own
tests of those compositions are marked for SPMD drift under this jaxlib),
and its rules partition without changing the result, so the port's tp runs
are held against JAX's single-device run: the flax model's logits, loss
and gradients (``jax.value_and_grad``), the JAX inference engine's greedy
tokens and int8 logits, and the JAX training engine on one device. The
port runs on gloo ranks in child processes (``python
tests/test_torch_tensor_parallel.py --worker ...``, torch and the port
only, one thread each), every rank building only its shard of the model
from the JAX weights (``module_inject.jax_params.shard_state_dict``). One
spawn per world size serves every case of the file (2 ranks: tp 2; 4
ranks: tp 2 x dp 2 at ZeRO stages 1 and 3, whose tag loads on one process
and passes JAX's ``verify_tag_dir``).

Two narrow 2-layer models: LLaMA-shaped (RMSNorm, SwiGLU, rotary, GQA with
4 query and 2 KV heads, an untied vocab-parallel head) and GPT-2-shaped
(LayerNorm, biases, learned positions, a tied vocab-parallel ``wte``);
a BLOOM-shaped one (ALiBi) for the forward and backward alone. In
f32 the two frameworks differ only in the order of sums (the tp ranks add
their partial products in another order still): logits to atol 1e-4, the
loss to rtol 1e-5, every gradient to 1e-5 of its largest entry, training
losses and grad norms to rtol 1e-5 and the updates to 1e-3 in relative L2
(``tests/test_torch_zero.py``'s bounds), greedy tokens exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
NORM_RTOL = 1e-5
UPDATE_REL_L2 = 1e-3
LR = 1e-3
STEPS = 3
SEQ = 16
NEW_TOKENS = 6

LLAMA = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
             n_kv_head=2, intermediate_size=96, layer_norm_epsilon=1e-5,
             norm="rmsnorm", activation="silu", gated_mlp=True,
             use_bias=False, attn_bias=False, rotary=True,
             learned_positions=False, tie_word_embeddings=False)
GPT2 = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)
MODELS = {"llama": LLAMA, "gpt2": GPT2}
# BLOOM-shaped (ALiBi: each rank's heads take their slopes), forward and
# backward only
BLOOM = dict(GPT2, alibi=True, embed_layernorm=True, learned_positions=False)


def ds_config(micro, mesh, stage=0):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_clipping": 0.5,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage},
            "tpu": {"mesh": mesh}}


def ids_of(shape, seed, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, size=shape)


def train_batches(rows, seed=7, vocab=128):
    return [{"input_ids": ids_of((rows, SEQ), seed + i, vocab),
             "labels": ids_of((rows, SEQ), seed + i, vocab)}
            for i in range(STEPS)]


# ---------------------------------------------------------------------------
# the ranks: child processes of the port only
# ---------------------------------------------------------------------------
def spawn(jobs, world, tmp_path):
    """Start ``jobs`` on ``world`` gloo ranks running this file's worker;
    returns their results, waited for at first use
    (``test_torch_zero.RanksRunning``)."""
    from test_torch_zero import start_ranks

    return start_ranks(jobs, tmp_path, world, worker=__file__)


def _cfg(job, **over):
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    return tlm.GPTConfig(**{**job["fields"], **over}, dtype=torch.float32)


def _model_job(job, rank):
    """The rank's shard of the model from the whole JAX weights: logits,
    loss, the gradients gathered whole, the rank's own gradients of the
    replicated leaves, and the whole state gathered back."""
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject import jax_params
    from deepspeed_tpu_torch.parallel.mesh import (MeshTopology,
                                                   set_default_topology)
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    topo = MeshTopology(**job["mesh"])
    set_default_topology(topo)
    layout = ParallelLayout.from_topology(topo,
                                          rows_split=job.get("rows_split",
                                                             False))
    cfg = _cfg(job)
    model = tlm.GPT(cfg, parallel=layout)
    sd = jax_params.shard_state_dict(job["sd"], cfg, topo)
    model.load_state_dict(sd, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    out = {"local_shapes": {k: tuple(v.shape) for k, v in sd.items()}}
    ids = torch.from_numpy(job["ids"]).long()
    rows = slice(None)
    if job.get("rows_split") and topo.size("ep") > 1:
        # ep is a batch axis: each rank takes its rows
        n = ids.shape[0] // topo.size("ep")
        r = topo.axis_index("ep")
        rows = slice(r * n, (r + 1) * n)
    model.eval()
    with torch.no_grad():
        out["logits"] = model(ids[rows])
    model.train()
    loss = model(ids[rows], labels=ids[rows])
    (loss * job.get("loss_scale", 1.0)).backward()
    out["loss"] = float(loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    out["local_grads"] = {n: g.clone() for n, g in grads.items()}
    out["grads"] = jax_params.gather_state_dict(grads, cfg, topo)
    out["state"] = jax_params.gather_state_dict(model.state_dict(), cfg, topo)
    return out


def _serve_job(job, rank):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    eng = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_cfg(job)), dtype=job["dtype"], device="cpu",
        state_dict=job["sd"], **job["sizes"])
    ids = torch.from_numpy(job["ids"]).long()
    out = {"logits": eng(ids),
           "tokens": eng.generate(ids[:, :8], max_new_tokens=NEW_TOKENS),
           "cache_heads": eng._decoder(ids.shape[0]).cache.key[0].shape[2]}
    if job.get("sampled"):
        # a generator seeded alike on every rank: the same draws
        out["sampled"] = eng.generate(ids[:, :8], max_new_tokens=NEW_TOKENS,
                                      temperature=1.0)
    return out


def _train_job(job, rank):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(_cfg(job)), config=job["config"], device="cpu",
        model_parameters={k: v.clone() for k, v in job["sd"].items()})[0]
    out = {"losses": [], "norms": []}
    for step in job["steps"]:
        out["losses"].append(float(engine.train_batch(iter(step))))
        out["norms"].append(engine.get_global_grad_norm())
    out["params"] = engine.params
    if job.get("save"):
        engine.save_checkpoint(job["save"])
    return out


def _worker(argv):
    spec, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import reset_default_topology

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                          device_type="cpu")
    run = {"model": _model_job, "serve": _serve_job, "train": _train_job}
    results = {}
    for job in torch.load(spec, weights_only=False):
        reset_default_topology()
        results[job["name"]] = run[job["kind"]](job, rank)
    torch.save(results, out)
    comm.destroy_distributed()
    return 0


# ---------------------------------------------------------------------------
# the parent: the JAX package's single-device runs
# ---------------------------------------------------------------------------
def jax_engine(fields, dtype="fp32", seed=0):
    import deepspeed_tpu
    import jax.numpy as jnp

    from deepspeed_tpu.models import transformer_lm as jlm

    eng = deepspeed_tpu.init_inference(
        jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32)), dtype=dtype,
        seed=seed)
    # the engine's weights, drawn as its first call would draw them
    eng._materialize(jnp.zeros((1, 8), jnp.int32))
    return eng


def port_weights(jeng, fields):
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    return gpt_state_dict_from_jax(
        jax.device_get(jeng.params),
        tlm.GPTConfig(**fields, dtype=torch.float32))


def jax_loss_and_grads(fields, params, ids):
    """The flax model's logits, loss and gradients (port names), in one
    jitted program."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import transformer_lm as jlm
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    jmodel = jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32))
    x = jnp.asarray(ids, jnp.int32)

    def loss(p):
        logits = jmodel.apply({"params": p}, x, deterministic=True)
        return (jmodel.apply({"params": p}, x, labels=x, deterministic=True),
                logits)

    (value, logits), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    tcfg = tlm.GPTConfig(**fields, dtype=torch.float32)
    return (np.asarray(logits), float(value),
            gpt_state_dict_from_jax(jax.device_get(grads), tcfg))


def jax_train(fields, params, steps):
    """The JAX engine on one device: losses, grad norms, final params."""
    import deepspeed_tpu
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import transformer_lm as jlm
    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    rows = len(steps[0][0]["input_ids"])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32)),
        config={k: v for k, v in ds_config(rows, {}).items() if k != "tpu"},
        model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    losses, norms = [], []
    for step in steps:
        losses.append(float(jeng.train_batch(iter(step))))
        norms.append(float(jeng.get_global_grad_norm()))
    tcfg = tlm.GPTConfig(**fields, dtype=torch.float32)
    return {"losses": losses, "norms": norms,
            "params": gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                              tcfg)}


def assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-9, f"{name}: {err} of {scale}"


def assert_updates(got, want, start):
    diff_sq = upd_sq = 0.0
    for name, w in want.items():
        g, s, w = got[name].float(), start[name].float(), w.float()
        diff_sq += float(((g - w) ** 2).sum())
        upd_sq += float(((w - s) ** 2).sum())
    assert (diff_sq / upd_sq) ** 0.5 <= UPDATE_REL_L2


def assert_run(got, want, start):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL)
    assert_updates(got["params"], want["params"], start)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns (started first, so that the JAX runs overlap them) and
    the JAX references."""
    import jax.numpy as jnp

    ids = ids_of((2, SEQ), 1)
    engines = {name: jax_engine(fields) for name, fields in MODELS.items()}
    sd = {name: port_weights(engines[name], fields)
          for name, fields in MODELS.items()}
    steps2 = [[b] for b in train_batches(2)]
    steps4 = [[b] for b in train_batches(2)]   # the same global rows
    tag_dir = str(tmp_path_factory.mktemp("tp_tag"))
    engines["bloom"] = jax_engine(BLOOM)
    sd["bloom"] = port_weights(engines["bloom"], BLOOM)
    two = [dict(name=f"model_{n}", kind="model", fields=f, sd=sd[n],
                ids=ids, mesh={"tp": 2, "dp": 1})
           for n, f in dict(MODELS, bloom=BLOOM).items()]
    two += [dict(name=f"serve_{n}", kind="serve", fields=MODELS[n],
                 sd=sd[n], ids=ids, dtype="fp32", sizes={"mp_size": 2},
                 sampled=True)
            for n in MODELS]
    two += [dict(name="int8_llama", kind="serve", fields=LLAMA,
                 sd=sd["llama"], ids=ids, dtype="int8",
                 sizes={"mp_size": 2}),
            dict(name="train_tp2", kind="train", fields=LLAMA,
                 sd=sd["llama"], steps=steps2,
                 config=ds_config(2, {"tp": 2, "dp": 1}))]
    four = [dict(name=f"train_s{stage}", kind="train", fields=LLAMA,
                 sd=sd["llama"], steps=steps4,
                 config=ds_config(1, {"tp": 2, "dp": -1}, stage),
                 save=tag_dir if stage == 3 else None)
            for stage in (1, 3)]
    two = spawn(two, 2, tmp_path_factory.mktemp("tp2"))
    four = spawn(four, 4, tmp_path_factory.mktemp("tp2dp2"))

    ref = {}
    for name, fields in dict(MODELS, bloom=BLOOM).items():
        ref[f"model_{name}"] = jax_loss_and_grads(
            fields, engines[name].params, ids)
    for name in MODELS:
        ref[f"tokens_{name}"] = np.asarray(engines[name].generate(
            jnp.asarray(ids[:, :8], jnp.int32), max_new_tokens=NEW_TOKENS))
    # the int8 engine from the same seed holds the same dense weights
    j8 = jax_engine(LLAMA, dtype="int8")
    ref["int8_llama"] = np.asarray(j8(jnp.asarray(ids, jnp.int32)))
    ref["train"] = jax_train(LLAMA, engines["llama"].params, steps2)
    return dict(two=two, four=four, ref=ref, sd=sd, ids=ids,
                tag_dir=tag_dir, steps=steps2)


# -- no spawn ----------------------------------------------------------------
def _jax_paths(fields):
    """Every parameter path and shape of the flax GPT (``eval_shape``: no
    weights made), JAX's '/'-joined names."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import transformer_lm as jlm

    model = jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32))
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        deterministic=True))["params"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf.shape)
            for path, leaf in flat]


RULE_CONFIGS = {
    # GPT-2's vocabulary (50257: tp 2 does not divide it, wte stays whole)
    "gpt2": dict(GPT2, vocab_size=50257),
    "mistral": dict(LLAMA, vocab_size=32000, n_head=8, n_kv_head=2),
    "mixtral": dict(LLAMA, vocab_size=32000, moe_num_experts=8, moe_top_k=2,
                    moe_gated_experts=True),
}


@pytest.mark.parametrize("name", sorted(RULE_CONFIGS))
@pytest.mark.parametrize("tp,ep", [(2, 1), (2, 2), (4, 2)])
def test_tp_rules_are_jax_rules(name, tp, ep):
    """``gpt_tp_rules`` and ``moe_param_spec`` equal JAX's on every
    parameter path, and with the axis sizes JAX's ``ZeroShardingRules``
    stripping (a dimension tp does not divide stays whole)."""
    import jax
    from jax.sharding import PartitionSpec

    from deepspeed_tpu.models.transformer_lm import gpt_tp_rules as jrules
    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu.runtime.zero.sharding import ZeroShardingRules
    from deepspeed_tpu_torch.parallel.tensor import gpt_tp_rules

    def tup(spec, ndim):
        if spec is None:
            return None
        assert isinstance(spec, PartitionSpec)
        return tuple(spec) + (None,) * (ndim - len(spec))

    topo = MeshTopology(tp=tp, ep=ep, dp=1, devices=jax.devices()[:tp * ep])
    rules = ZeroShardingRules(topo, stage=0, tp_rules=jrules)
    paths = _jax_paths(RULE_CONFIGS[name])
    assert len(paths) >= 8
    for path, shape in paths:
        nd = len(shape)
        assert gpt_tp_rules(path, shape) == tup(jrules(path, shape), nd), path
        assert gpt_tp_rules(path, shape, {"tp": tp, "ep": ep}) == tup(
            rules._tp_spec(path, shape), nd), path


@pytest.mark.parametrize("tp,h,hkv", [(2, 4, 2), (4, 8, 2), (4, 4, 2),
                                      (2, 4, 1)])
def test_c_attn_is_head_aligned(tp, h, hkv):
    """Rank r's ``c_attn`` rows (the JAX kernel's columns) are its query
    heads', then its KV heads' keys and values: a permutation of JAX's
    contiguous shard, built here independently. With fewer KV heads than
    ranks each rank holds the one KV head its queries read."""
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.parallel.tensor import (ParallelLayout,
                                                     shard_tensor)

    cfg = tlm.GPTConfig(**dict(LLAMA, n_head=h, n_kv_head=hkv),
                        dtype=torch.float32)
    D = cfg.head_dim
    w = torch.arange((h + 2 * hkv) * D, dtype=torch.float32)[:, None].expand(
        -1, 3)
    seen = set()
    for r in range(tp):
        got = shard_tensor("h.0.attn.c_attn.weight", w, cfg,
                           ParallelLayout(tp=tp, tp_rank=r))[:, 0].long()
        qh = range(r * h // tp, (r + 1) * h // tp)
        kvh = ([r * hkv // tp + i for i in range(hkv // tp)] if hkv >= tp
               else [r // (tp // hkv)])
        want = ([q * D + i for q in qh for i in range(D)]
                + [(h + k) * D + i for k in kvh for i in range(D)]
                + [(h + hkv + k) * D + i for k in kvh for i in range(D)])
        assert got.tolist() == want
        seen.update(want)
    assert seen == set(range((h + 2 * hkv) * D))


def test_layout_refusals_name_their_constraint():
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    with pytest.raises(ValueError, match="n_head"):
        tlm.GPT(tlm.GPTConfig(**dict(LLAMA, n_head=2, n_kv_head=2)),
                parallel=ParallelLayout(tp=4))
    with pytest.raises(ValueError, match="n_kv_head"):
        tlm.GPT(tlm.GPTConfig(**dict(LLAMA, n_head=12, n_kv_head=3,
                                     n_embd=96)),
                parallel=ParallelLayout(tp=4))
    # a sparse_attention layout under tp (refused until ROADMAP A.9 part
    # 2a): each rank's attention keeps its heads' layouts
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    sparse = FixedSparsityConfig(num_heads=4, block=16,
                                 different_layout_per_head=True)
    whole = sparse.make_layout(64)
    for r in (0, 1):
        attn = tlm.GPT(tlm.GPTConfig(**LLAMA, sparse_attention=sparse),
                       parallel=ParallelLayout(tp=2, tp_rank=r)).h[0].attn
        np.testing.assert_array_equal(attn.sparse.get_layout(64),
                                      whole[2 * r:2 * r + 2])


# -- 2 ranks, tp 2 -----------------------------------------------------------
@pytest.mark.parametrize("model", sorted(MODELS) + ["bloom"])
def test_logits_loss_and_gradients_match_jax(model, runs):
    want_logits, want_loss, want_grads = runs["ref"][f"model_{model}"]
    for r in runs["two"]:
        got = r[f"model_{model}"]
        np.testing.assert_allclose(got["logits"].numpy(), want_logits,
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
        assert_grads(got["grads"], want_grads)
        # shard then gather is the identity
        for k, v in runs["sd"][model].items():
            assert torch.equal(got["state"][k], v), k


@pytest.mark.parametrize("model", sorted(MODELS))
def test_replicated_gradients_equal_on_every_rank(model, runs):
    """Every replicated leaf (the norms, biases of row-parallel layers,
    positions) gets the same gradient on both ranks: the column-parallel
    inputs' all-reduce in the backward is in place. The split leaves
    differ (each rank's own columns)."""
    a, b = (r[f"model_{model}"] for r in runs["two"])
    names = sorted(a["local_grads"])
    # ln_1, ln_2 of each layer and ln_f, with their biases under LayerNorm
    per = 2 if MODELS[model].get("norm", "layernorm") == "layernorm" else 1
    assert len([n for n in names if "ln_" in n]) == per * (
        2 * MODELS[model]["n_layer"] + 1)
    split = 0
    for n in names:
        if a["local_shapes"][n] == tuple(runs["sd"][model][n].shape):
            assert torch.equal(a["local_grads"][n], b["local_grads"][n]), n
        else:
            split += 1
            assert not torch.equal(a["local_grads"][n], b["local_grads"][n])
    assert split > 0


@pytest.mark.parametrize("model", sorted(MODELS))
def test_greedy_decode_matches_jax(model, runs):
    for r in runs["two"]:
        got = r[f"serve_{model}"]
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      runs["ref"][f"tokens_{model}"])
        np.testing.assert_allclose(
            got["logits"].numpy(), runs["ref"][f"model_{model}"][0],
            atol=ATOL, rtol=0)
        # the cache holds the rank's KV heads
        fields = MODELS[model]
        assert got["cache_heads"] == fields.get("n_kv_head",
                                                fields["n_head"]) // 2
    a, b = (r[f"serve_{model}"]["sampled"] for r in runs["two"])
    assert torch.equal(a, b)


def test_int8_tp_logits_match_jax_int8(runs):
    for r in runs["two"]:
        np.testing.assert_allclose(r["int8_llama"]["logits"].numpy(),
                                   runs["ref"]["int8_llama"], atol=ATOL,
                                   rtol=0)


def test_training_at_tp2_matches_jax(runs):
    for r in runs["two"]:
        assert_run(r["train_tp2"], runs["ref"]["train"], runs["sd"]["llama"])


# -- 4 ranks, tp 2 x dp 2 ------------------------------------------------------
@pytest.mark.parametrize("stage", [1, 3])
def test_tp2_dp2_matches_jax(stage, runs):
    for r in runs["four"]:
        assert_run(r[f"train_s{stage}"], runs["ref"]["train"],
                   runs["sd"]["llama"])


def test_tag_at_tp2_dp2_loads_at_tp1_and_verifies_in_jax(runs):
    import deepspeed_tpu_torch
    from deepspeed_tpu.runtime.checkpoint_manifest import verify_tag_dir
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    saved = runs["four"][0]["train_s3"]["params"]   # the ranks have ended
    tag = os.path.join(runs["tag_dir"], f"global_step{STEPS}")
    assert verify_tag_dir(tag) == []
    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**LLAMA, dtype=torch.float32)),
        config={k: v for k, v in ds_config(2, {}).items() if k != "tpu"},
        device="cpu")[0]
    engine.load_checkpoint(runs["tag_dir"])
    for k, v in engine.params.items():
        assert torch.equal(v, saved[k]), k
    assert engine.global_steps == STEPS
    loss = engine.train_batch(iter(runs["steps"][0]))
    assert bool(torch.isfinite(loss))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
