"""The port's recomputation policies against the JAX package's.

``remat_policy`` (``models/transformer_lm.py`` ``_remat_policy``) under each
of JAX's four names: the loss and every gradient against the JAX model's
under the same policy (f32; on the flash path the JAX side runs its Pallas
kernels in interpret mode, the port its plain versions), and how often the
flash forward runs per layer (2 under ``full`` and ``save_dots``, 1 under
``selective`` and ``save_nothing_but_flash``, which keep its o and lse).
Then ``runtime/activation_checkpointing``'s module API against
``tests/unit/test_activation_checkpointing.py``'s cases, on the same numpy
inputs through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=2)
POLICIES = ("full", "selective", "save_dots", "save_nothing_but_flash")
# flash forward runs per layer and training step
FLASH_FWD_PER_LAYER = {"full": 2, "selective": 1, "save_dots": 2,
                       "save_nothing_but_flash": 1}


@pytest.fixture(autouse=True)
def _clean():
    ac.reset()
    jac.reset()
    yield
    ac.reset()
    jac.reset()


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], size=(b, t)).astype(np.int32)


def _pair(policy, flash, remat=True, **over):
    jcfg = jlm.GPTConfig(**SMALL, use_flash_attention=flash, remat=remat,
                         remat_policy=policy, dtype=jnp.float32, **over)
    jmodel = jlm.GPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**SMALL, use_flash_attention=flash, remat=remat,
                         remat_policy=policy, dtype=torch.float32, **over)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(jax.device_get(params),
                                                   tcfg), assign=True)
    tmodel.train()
    for p in tmodel.parameters():
        p.requires_grad_(True)
    return jmodel, params, tmodel


def _counting(monkeypatch):
    """Count the flash forward's runs (B1, or its plain version here)."""
    calls = [0]
    real = fa.flash_attention_fwd

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    return calls


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_loss_and_gradients_match_jax(policy, flash, monkeypatch):
    """f32 loss and every gradient against JAX's same policy, relative to
    each gradient's largest entry: 1e-5 (the order of sums only)."""
    jmodel, params, tmodel = _pair(policy, flash)
    ids = _ids(2, 128, seed=3)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            labels=jnp.asarray(ids), deterministic=False)

    jl, jg = jax.value_and_grad(jloss)(params)
    calls = _counting(monkeypatch)
    t = torch.from_numpy(ids).long()
    tl = tmodel(t, labels=t)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = gpt_state_dict_from_jax(jax.device_get(jg), tmodel.config)
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-5 * scale + 1e-9, f"{name}: {err} of {scale}"
    per_layer = FLASH_FWD_PER_LAYER[policy] if flash else 0
    assert calls[0] == per_layer * SMALL["n_layer"]


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_change_no_value(policy):
    """Every policy's gradients equal those of the model without remat
    bit for bit: a policy changes what is saved, never a value."""
    ids = torch.from_numpy(_ids(2, 128, seed=4)).long()
    grads = []
    for remat in (False, True):
        _, _, tmodel = _pair(policy, True, remat=remat)
        tmodel(ids, labels=ids).backward()
        grads.append({n: p.grad for n, p in tmodel.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name


def test_flash_forward_is_one_dispatcher_op_with_named_outputs():
    """B1 reaches the dispatcher as deepspeed_tpu_torch::flash_fwd, whose
    outputs carry the JAX kernel's checkpoint names."""
    op = torch.ops.deepspeed_tpu_torch.flash_fwd.default
    keep = ac.save_only_these_names("attn_out", "attn_lse")
    assert keep(None, op)
    assert not keep(None, torch.ops.aten.mm.default)
    assert ac.dots_with_no_batch_dims_saveable(None, torch.ops.aten.addmm.default)
    assert not ac.dots_with_no_batch_dims_saveable(None, torch.ops.aten.bmm.default)
    assert ac.dots_saveable(None, torch.ops.aten.bmm.default)
    assert not ac.dots_saveable(None, op)
    q = torch.randn(1, 64, 2, 32)
    o, lse = torch.ops.deepspeed_tpu_torch.flash_fwd(q, q, q, None, True, 0.25)
    ro, rlse = fa.flash_attention_reference(q, q, q, causal=True, scale=0.25)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tlm.GPTConfig(remat=True, remat_policy="bogus")


# -- the module API, on tests/unit/test_activation_checkpointing.py's cases --
def _mlp_np():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 32).astype(np.float32),
            rng.randn(32, 16).astype(np.float32),
            rng.randn(4, 16).astype(np.float32))


def _jmlp(w1, w2, x):
    return jnp.sum(jnp.tanh(jnp.tanh(x @ w1) @ w2) ** 2)


def _tmlp(w1, w2, x):
    return torch.sum(torch.tanh(torch.tanh(x @ w1) @ w2) ** 2)


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
def test_checkpoint_matches_plain_and_jax(remat):
    """The checkpointed value and gradient equal the plain ones, and JAX's
    checkpoint under the same policy (1e-5 relative to the value and to the
    gradient's largest entry: the order of sums)."""
    ac.configure(remat=remat)
    jac.configure(remat=remat)
    assert ac.is_configured()
    w1, w2, x = _mlp_np()
    jval = jac.checkpoint(_jmlp, *map(jnp.asarray, (w1, w2, x)))
    jgrad = jax.grad(lambda w: jac.checkpoint(
        _jmlp, w, jnp.asarray(w2), jnp.asarray(x)))(jnp.asarray(w1))

    tw1 = torch.tensor(w1, requires_grad=True)
    tw2, tx = torch.tensor(w2), torch.tensor(x)
    plain = _tmlp(tw1, tw2, tx)
    (plain_grad,) = torch.autograd.grad(plain, tw1)
    val = ac.checkpoint(_tmlp, tw1, tw2, tx)
    (grad,) = torch.autograd.grad(val, tw1)
    assert torch.equal(val, plain) and torch.equal(grad, plain_grad)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


def test_checkpoint_wrapper_recomputes():
    """The wrapper's backward runs the function again (the recompute),
    except under the "none" policy."""
    ac.configure(remat="full")
    w1, w2, x = (torch.tensor(a) for a in _mlp_np())
    w1.requires_grad_(True)
    runs = [0]

    def f(a, b, c):
        runs[0] += 1
        return _tmlp(a, b, c)

    g = torch.autograd.grad(ac.checkpoint_wrapper(f)(w1, w2, x), w1)[0]
    assert runs[0] == 2
    torch.testing.assert_close(g, torch.autograd.grad(_tmlp(w1, w2, x), w1)[0],
                               rtol=0, atol=0)
    ac.configure(remat="none")
    runs[0] = 0
    torch.autograd.grad(ac.CheckpointFunction(f)(w1, w2, x), w1)
    assert runs[0] == 1


def test_configure_from_engine_config():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({
        "train_batch_size": 8,
        "activation_checkpointing": {"partition_activations": True,
                                     "number_checkpoints": 2},
    })
    state = ac.configure(cfg, remat="selective")
    assert state.config.partition_activations
    assert state.number_checkpoints == 2
    assert state.policy is ac.dots_with_no_batch_dims_saveable


def test_policy_mapping():
    assert ac.policy_from_config(None, "none") is ac.everything_saveable
    assert ac.policy_from_config(None, "full") is ac.nothing_saveable
    assert (ac.policy_from_config(None, "selective")
            is ac.dots_with_no_batch_dims_saveable)
    with pytest.raises(ValueError):
        ac.policy_from_config(None, "bogus")


def test_cpu_checkpointing_is_refused_naming_its_item():
    with pytest.raises(NotImplementedError, match="A.10"):
        ac.configure(checkpoint_in_cpu=True)


def test_draws_are_handed_back_to_the_recompute():
    """A mask drawn inside a checkpointed call is the same tensor in its
    recompute, and the generator is not advanced by the recompute."""
    gen = torch.Generator().manual_seed(0)
    seen = []

    def f(x):
        m = ac.bernoulli_mask(x.shape, 0.5, gen, x.device)
        seen.append(m)
        return (x * m).sum()

    x = torch.randn(64, requires_grad=True)
    out = ac.checkpoint(f, x, policy=ac.nothing_saveable)
    state = gen.get_state()
    out.backward()
    assert len(seen) == 2 and seen[0] is seen[1]
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(x.grad, seen[0].float())


def test_rng_tracker_deterministic_fork():
    def draw(g):
        return torch.rand(8, generator=g)

    ac.model_parallel_reconfigure(seed=1234, tp_rank=0)
    t = ac.get_rng_tracker()
    a0, a1 = draw(t.fork()), draw(t.fork())
    assert not torch.equal(a0, a1)
    ac.model_parallel_reconfigure(seed=1234, tp_rank=0)
    assert torch.equal(a0, draw(ac.get_rng_tracker().fork()))
    ac.model_parallel_reconfigure(seed=1234, tp_rank=1)
    assert not torch.equal(a0, draw(ac.get_rng_tracker().fork()))


def test_rng_tracker_state_roundtrip():
    ac.model_parallel_reconfigure(seed=7)
    t = ac.get_rng_tracker()
    saved = t.get_states()
    x = torch.rand(4, generator=t.fork())
    t.set_states(saved)
    y = torch.rand(4, generator=t.fork())
    assert torch.equal(x, y)
    with pytest.raises(KeyError):
        t.fork("never-added")
    with pytest.raises(ValueError):
        t.add("default", 3)


def test_engine_configures_the_module_policy():
    """initialize configures the module-level policy from the
    activation_checkpointing block and tpu.remat (JAX engine :541-546),
    as deepspeed_tpu.initialize does."""
    import deepspeed_tpu_torch

    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    deepspeed_tpu_torch.initialize(
        model=tlm.GPT(cfg), device="cpu", config=dict(
            train_micro_batch_size_per_gpu=1,
            optimizer=dict(type="Adam", params=dict(lr=1e-3)),
            activation_checkpointing=dict(partition_activations=True,
                                          number_checkpoints=3),
            tpu=dict(remat="selective")))
    assert ac.is_configured()
    state = ac.checkpointing._CONFIG
    assert state.remat == "selective" and state.number_checkpoints == 3
    assert state.config.partition_activations
    assert state.policy is ac.dots_with_no_batch_dims_saveable


OPTIONS = [dict(remat=True, remat_policy=p) for p in POLICIES] + [
    dict(dropout=0.1), dict(stochastic_mode=True), dict(fused_head_ce=True),
    dict(fused_head_ce=512), dict(attention_chunk=64),
    dict(use_flash_attention="auto")]


@pytest.mark.parametrize("over", OPTIONS, ids=lambda o: ",".join(
    f"{k}={v}" for k, v in o.items()))
def test_options_leave_the_parameter_tree_as_it_is(over):
    """No training option adds a leaf: JAX's parameter tree under the
    option is the default one (paths and shapes), the port's state dict
    too, and the bridge carries the tree over under either config."""
    def jax_tree(**o):
        model = jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32, **o))
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                            deterministic=True)["params"]
        return {jax.tree_util.keystr(path): leaf.shape for path, leaf in
                jax.tree_util.tree_leaves_with_path(params)}, params

    want, params = jax_tree()
    got, _ = jax_tree(**over)
    assert got == want
    base = tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32))
    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32, **over)
    model = tlm.GPT(tcfg)
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in base.state_dict().items()}
    sd = gpt_state_dict_from_jax(jax.device_get(params), tcfg)
    model.load_state_dict(sd, assign=True)
