"""The port's LM-training optimizers against the reference's.

adafactor (factored and full second moments, its β_t = 1 − t^(−decay)
schedule), global-norm clipping, ``chain_clip`` and ``with_accumulation``
take the same seeded numpy gradients in both packages for three or more
updates; updates, parameters and states agree at 1e-6. Adam-like inner
optimizers use eps = 1e-6 (ROADMAP Queue 3: at 1e-8, gradient entries
within rounding noise of zero become steps of ±lr). ``load_jax_opt_state``
carries a reference state across, and the port's next step equals the
reference's. Everything runs on the CPU.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim
from repro_torch.core.tree import as_numpy, tree_leaves

TOL = 1e-6


def _params(seed=0):
    """Matrices (factored by adafactor), a stacked 3-D leaf (the layer axis
    of a DecoderLM block) and vectors (full moments)."""
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.normal(size=(12, 7)).astype(np.float32)},
            "blocks": {"w": rng.normal(size=(3, 5, 6)).astype(np.float32),
                       "scale": (1 + 0.1 * rng.normal(size=(3, 6))).astype(np.float32)},
            "bias": rng.normal(size=(9,)).astype(np.float32)}


def _grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32), params)


def _run_both(jopt, topt, steps, scale=1.0):
    """Apply ``steps`` updates of the same gradients in both packages;
    compare every update, then the final parameters. → (jax state, port state)."""
    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        g = _grads(params, 10 + step, scale)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        tupd, tstate = topt.update(jax.tree.map(torch.from_numpy, g), tstate, tp)
        for a, b in zip(jax.tree.leaves(jupd), tree_leaves(tupd)):
            np.testing.assert_allclose(as_numpy(b), np.asarray(a), rtol=TOL, atol=TOL,
                                       err_msg=f"update {step}")
        jp = joptim.apply_updates(jp, jupd)
        tp = optim.apply_updates(tp, tupd)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(as_numpy(b), np.asarray(a), rtol=TOL, atol=TOL)
    return jstate, tstate


@pytest.mark.parametrize("decay", [0.8, 0.5])
def test_adafactor_matches_reference_over_three_updates(decay):
    jstate, tstate = _run_both(joptim.adafactor(1e-2, decay=decay),
                               optim.adafactor(1e-2, decay=decay), 3)
    assert tstate["step"] == int(jstate["step"]) == 3
    # the factored moments: row means (vr) and column means (vc) per matrix
    assert set(tstate["moments"]["dense"]["w"]) == {"vr", "vc"}
    assert tuple(tstate["moments"]["blocks"]["w"]["vc"].shape) == (3, 6)
    assert set(tstate["moments"]["bias"]) == {"v"}
    for a, b in zip(jax.tree.leaves(jstate["moments"]), tree_leaves(tstate["moments"])):
        np.testing.assert_allclose(as_numpy(b), np.asarray(a), rtol=TOL, atol=TOL)


def test_adafactor_with_a_schedule_matches_reference():
    sched = dict(lr=1e-2, warmup_steps=2, total_steps=6)
    _run_both(joptim.adafactor(joptim.warmup_cosine_schedule(**sched)),
              optim.adafactor(optim.warmup_cosine_schedule(**sched)), 4)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads(_params(), 3)
    jn = joptim.global_norm(jax.tree.map(jnp.asarray, g))
    tn = optim.global_norm(jax.tree.map(torch.from_numpy, g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    jc = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc = optim.clip_by_global_norm(jax.tree.map(torch.from_numpy, g), max_norm)
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_allclose(as_numpy(b), np.asarray(a), rtol=TOL, atol=TOL)
    clipped = float(optim.global_norm(tc))
    assert clipped == pytest.approx(min(max_norm, float(tn)), rel=1e-5)


def test_clip_of_bf16_grads_comes_back_f32_as_in_reference():
    g = {"w": np.random.default_rng(0).normal(size=(4, 4)).astype(ml_dtypes.bfloat16)}
    jc = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.1)
    tc = optim.clip_by_global_norm({"w": torch.from_numpy(g["w"].astype(np.float32))
                                    .to(torch.bfloat16)}, 0.1)
    assert jc["w"].dtype == jnp.float32 and tc["w"].dtype == torch.float32
    np.testing.assert_allclose(tc["w"].numpy(), np.asarray(jc["w"]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("inner", ["adam", "adafactor"])
def test_chain_clip_matches_reference_over_three_updates(inner):
    make = {"adam": lambda m: m.adam(1e-2, eps=1e-6), "adafactor": lambda m: m.adafactor(1e-2)}
    jopt, topt = joptim.chain_clip(make[inner](joptim), 0.5), optim.chain_clip(make[inner](optim), 0.5)
    assert topt.name == jopt.name
    _run_both(jopt, topt, 3, scale=3.0)


@pytest.mark.parametrize("accumulate", [2, 3])
def test_with_accumulation_matches_reference(accumulate):
    """Updates are zeros until the accumulate-th micro-step, then the inner
    optimizer's step on the mean gradient; acc and count reset."""
    jopt = joptim.with_accumulation(joptim.adamw(1e-2, eps=1e-6), accumulate)
    topt = optim.with_accumulation(optim.adamw(1e-2, eps=1e-6), accumulate)
    assert topt.name == jopt.name
    jstate, tstate = _run_both(jopt, topt, accumulate + 1)
    assert tstate["count"] == int(jstate["count"]) == 1
    assert tstate["inner"]["step"] == int(jstate["inner"]["step"]) == 1
    for a, b in zip(jax.tree.leaves(jstate["acc"]), tree_leaves(tstate["acc"])):
        np.testing.assert_allclose(as_numpy(b), np.asarray(a), rtol=TOL, atol=TOL)


def test_with_accumulation_of_one_is_the_inner_optimizer():
    inner = optim.adam(1e-3)
    assert optim.with_accumulation(inner, 1) is inner


def test_optimizer_registry_and_scale_state_match_reference():
    assert sorted(optim.OPTIMIZERS) == sorted(joptim.OPTIMIZERS)
    assert optim.get_optimizer("adafactor", 1e-3).name == "adafactor"
    assert optim.ScaleState._fields == joptim.ScaleState._fields
    with pytest.raises(KeyError):
        optim.get_optimizer("lamb", 1e-3)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "accumulated_adam"])
def test_reference_optimizer_state_carries_over(name):
    """Two reference steps, the state carried over with
    ``load_jax_opt_state``, then the third step in the port equals the
    reference's third step."""
    make = {"adamw": lambda m: m.adamw(1e-2, eps=1e-6),
            "adafactor": lambda m: m.adafactor(1e-2),
            "accumulated_adam": lambda m: m.with_accumulation(m.adam(1e-2, eps=1e-6), 2)}
    jopt, topt = make[name](joptim), make[name](optim)
    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    for step in range(2):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, _grads(params, step)), jstate, jp)
        jp = joptim.apply_updates(jp, upd)
    tstate = optim.load_jax_opt_state(jax.tree.map(np.asarray, jstate), device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jstate)) == jax.tree.structure(
        jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, tstate))
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    g = _grads(params, 2)
    jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
    tupd, tstate = topt.update(jax.tree.map(torch.from_numpy, g), tstate, tp)
    for a, b in zip(jax.tree.leaves(jupd), tree_leaves(tupd)):
        np.testing.assert_allclose(as_numpy(b), np.asarray(a), rtol=TOL, atol=TOL)


def test_apply_updates_rounds_bf16_parameters_once_as_reference():
    """A bf16 weight takes p + u in f32, rounded once: an update below half
    a bf16 ulp of p can still carry the sum over a rounding boundary, as in
    the reference, and is not zeroed by rounding u to bf16 first."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(4096,)).astype(ml_dtypes.bfloat16)
    u = (rng.normal(size=(4096,)) * 3e-3).astype(np.float32)
    want = np.asarray(joptim.apply_updates({"w": jnp.asarray(p)}, {"w": jnp.asarray(u)})["w"])
    tp = {"w": torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16)}
    got = optim.apply_updates(tp, {"w": torch.from_numpy(u)})["w"]
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
