"""The port's federated LM training (paper §4.4) against the reference.

Seeded numpy inputs go through both packages, on the CPU:
- the losses (``softmax_cross_entropy``, ``token_accuracy``) at 1e-6;
- ``chunked_sdpa`` and its gradients (windows, softcap, bf16 probabilities,
  a ragged q-block) at 1e-5;
- ``DecoderLM.loss`` and its gradients for a 2-layer pythia-14m and a
  2-layer mamba2-130m ``reduced()``, one pythia sequence above
  ``CHUNKED_THRESHOLD`` (``chunked_sdpa``), at 1e-4;
- ``launch.steps.make_train_step`` (remat on, 1 and 2 micro-batches) and
  ``training.make_train_step`` over 3 steps;
- the data: ``make_synthetic_wikitext``, ``lm_batch_iterator`` and
  ``partition_sequence_dataset`` draw the reference's exact tokens;
- ``launch.train.main(["--simulate", "2", "--reduced", ...])`` against the
  reference's ``main``: final parameters and eval metrics;
- a mixed fleet (one JAX node, one torch node on one ``InMemoryFolder``)
  against an all-JAX fleet.

The two packages' runs start from the same weights: both ``DecoderLM.init``
are patched to hand out numpy parameters per seed, and the reference's
per-node seed (``args.seed + hash(node_id) % 1000``, salted per process) is
patched to the port's stable ``node_seed``. Adam-like optimizers take
eps = 1e-6 (ROADMAP Queue 3: at 1e-8, gradient entries within
rounding noise of zero become steps of ±lr); the launchers' ``adamw(lr)`` is
patched to that eps in both packages.

The routing test shows that a training forward (``use_flash=False``) reaches
none of the forward-only kernel ops: each is patched to raise.
"""
import argparse
import functools
import json
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.train as jtrain
import repro.models.transformer as jtransformer
from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core.partition import partition_sequence_dataset as jpartition_sequence
from repro.data import lm_batch_iterator as jlm_batches
from repro.data import make_synthetic_wikitext as jwikitext
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.training import trainer as jtrainer
import repro_torch.launch.train as ttrain
import repro_torch.models.transformer as ttransformer
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import InMemoryFolder, run_threaded
from repro_torch.core.partition import partition_sequence_dataset
from repro_torch.core.tree import as_numpy, tree_leaves
from repro_torch.data import lm_batch_iterator, make_synthetic_wikitext
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssm_prefill import kernel as prefill_kernel
from repro_torch.kernels.ssm_prefill import ops as prefill_ops
from repro_torch.launch import steps
from repro_torch.models import attention, build_model, common, load_jax_params
from repro_torch.training import TrainState, make_train_step, value_and_grad

from _torch_parity import np_params

LOSS_TOL = 1e-4  # the reference's own tolerance for f32 model outputs


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tensors here are small: two intra-op threads do the work, and
    the suite's other workers keep the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(arch: str, seed: int = 0):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = np_params(jbuild_model(jcfg), seed)
    return jcfg, cfg, params, load_jax_params(build_model(cfg), params, device="cpu")


def _batch(cfg, B, S, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_vocab", [None, 300])
def test_cross_entropy_and_accuracy_match_reference(dtype, valid_vocab):
    """Log-softmax in f32 over (bf16) logits, the padded vocab tail masked."""
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.normal(size=(3, 7, 512)) * 4, dtype)
    labels = rng.integers(0, valid_vocab or 512, (3, 7)).astype(np.int32)
    labels[0, :4] = np.asarray(jnp.argmax(logits[0, :4], axis=-1))  # some hits
    tlogits = torch.from_numpy(np.array(logits.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jcommon.softmax_cross_entropy(logits, jnp.asarray(labels), valid_vocab)
    got = common.softmax_cross_entropy(tlogits, torch.from_numpy(labels), valid_vocab)
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    acc = common.token_accuracy(tlogits, torch.from_numpy(labels))
    assert float(acc) == pytest.approx(float(jcommon.token_accuracy(logits, jnp.asarray(labels))),
                                       abs=1e-6)
    assert float(acc) >= 4 / 21


@pytest.mark.parametrize("S,qblock,window,softcap,probs_bf16,causal", [
    (64, 16, 0, 0.0, False, True),
    (70, 32, 24, 0.0, False, True),   # ragged: the q-block falls to gcd(70, 32) = 2
    (96, 32, 40, 5.0, False, True),   # sliding K/V slices, softcap
    (64, 16, 0, 0.0, True, True),     # bf16 probabilities
    (48, 16, 0, 0.0, False, False),   # bidirectional
])
def test_chunked_sdpa_and_its_gradients_match_reference(S, qblock, window, softcap, probs_bf16,
                                                       causal):
    rng = np.random.default_rng(S)
    B, KV, G, hd = 2, 2, 2, 16
    q = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KV, hd)).astype(np.float32) for _ in range(2))
    r = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, qblock=qblock,
              probs_bf16=probs_bf16)

    def jloss(q, k, v):
        out = jattention.chunked_sdpa(q, k, v, **kw)
        return jnp.sum(out * r), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = attention.chunked_sdpa(tq, tk, tv, **kw)
    tg = torch.autograd.grad((tout * torch.from_numpy(r)).sum(), (tq, tk, tv))
    tol = 2e-2 if probs_bf16 else 1e-5
    _close(tout.detach(), jout, tol)
    for a, b, name in zip(tg, jg, "qkv"):
        _close(a, b, tol, f"d{name}")


def _jax_loss_and_grads(jcfg, params, batch, **kw):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jbuild_model(jcfg).loss(p, b, **kw),
                                    has_aux=True))
    return fn(params, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,S", [("pythia-14m", 33), ("pythia-14m", 1280),
                                    ("mamba2-130m", 70)])
def test_loss_and_gradients_match_reference(arch, S):
    """A 2-layer reduced() model, f32: loss, metrics and every gradient leaf
    at 1e-4. S = 1280 runs attention through chunked_sdpa (five q-blocks of
    256) in both packages; mamba2's S = 70 is two full chunks of 32 and a
    partial one."""
    jcfg, cfg, params, tparams = _pair(arch)
    assert cfg.n_layers == 2
    batch = _batch(cfg, 2, S)
    (jl, jm), jg = _jax_loss_and_grads(jcfg, params, batch)
    (tl, tm), tg = value_and_grad(build_model(cfg).loss, tparams,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, LOSS_TOL)
    for key in ("ce", "aux", "accuracy"):
        _close(tm[key], jm[key], LOSS_TOL, key)
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(leaves) == len(tree_leaves(tg))
    for (path, a), b in zip(leaves, tree_leaves(tg)):
        _close(b, a, LOSS_TOL, jax.tree_util.keystr(path))


def test_remat_changes_nothing_but_memory():
    """remat=True (torch.utils.checkpoint per layer group) gives the same
    loss and gradients as remat=False, and as the reference's remat=True."""
    jcfg, cfg, params, tparams = _pair("mamba2-130m", seed=3)
    batch = _batch(cfg, 2, 40, seed=4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = build_model(cfg)
    (l0, _), g0 = value_and_grad(lambda p, b: model.loss(p, b, remat=False), tparams, tb)
    (l1, _), g1 = value_and_grad(lambda p, b: model.loss(p, b, remat=True), tparams, tb)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    (jl, _), jg = _jax_loss_and_grads(jcfg, params, batch, remat=True)
    _close(l1, jl, LOSS_TOL)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(g1)):
        _close(b, a, LOSS_TOL)


def test_training_forward_reaches_no_forward_only_kernel(monkeypatch):
    """Under autograd with use_flash=False (the training default) the
    forward takes plain attention and ssd_chunked: with every kernel entry
    (the ops and the kernels' wrappers) patched to raise, a pythia and a
    mamba2 loss still differentiate. Serving's bulk prefill reaches them,
    so the patches are live."""
    def boom(*a, **k):
        raise AssertionError("a forward-only kernel op was reached in training")

    for mod, name in [(flash_ops, "flash_attention"), (dec_ops, "decode_attention"),
                      (ssd_ops, "ssd"), (flash_kernel, "flash_attention"),
                      (dec_kernel, "decode_attention"), (ssd_kernel, "ssd"),
                      (prefill_ops, "prefill_in"), (prefill_ops, "prefill_out"),
                      (prefill_kernel, "prefill_in"), (prefill_kernel, "prefill_out")]:
        monkeypatch.setattr(mod, name, boom)
    for arch, S in [("pythia-14m", 16), ("pythia-14m", 1280), ("mamba2-130m", 40)]:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, S).items()}
        params = model.init(0, device="cpu")
        with torch.enable_grad():
            (loss, _), grads = value_and_grad(
                lambda p, b: model.loss(p, b, remat=True, use_flash=False), params, batch)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree_leaves(grads))
        with pytest.raises(AssertionError, match="forward-only"):
            model.prefill(params, batch["tokens"], model.init_cache(1, S, device="cpu"))


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["pythia-14m", "mamba2-130m"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_launch_train_step_matches_reference_over_three_steps(arch, microbatches):
    """``make_train_step(cfg, adamw, remat=True, microbatches=m)``: the
    per-step loss and metrics, then the parameters after 3 steps, at 1e-4.
    Micro-batching accumulates f32 gradients / m in slice order in both."""
    jcfg, cfg, params, tparams = _pair(arch, seed=5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, joptim.adamw(1e-3, eps=1e-6),
                                           microbatches=microbatches))
    topt = optim.adamw(1e-3, eps=1e-6)
    tstep = steps.make_train_step(cfg, topt, microbatches=microbatches)
    jp = jax.tree.map(jnp.asarray, params)
    jstate, tstate = joptim.adamw(1e-3, eps=1e-6).init(jp), topt.init(tparams)
    for i in range(3):
        batch = _batch(cfg, 4, 24, seed=10 + i)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, tm = tstep(tparams, tstate, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
        assert set(tm) == set(jm)
        for key in jm:
            _close(tm[key], jm[key], LOSS_TOL, f"step {i} {key}")
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tparams)):
        _close(b, a, LOSS_TOL)


def test_trainer_make_train_step_matches_reference():
    """``training.make_train_step(loss_fn, optimizer)`` over 3 steps, with a
    TrainState carrying the step count as the reference's does."""
    jcfg, cfg, params, tparams = _pair("pythia-14m", seed=6)
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jstep = jax.jit(jtrainer.make_train_step(lambda p, b, r: jm.loss(p, b),
                                             joptim.adam(1e-3, eps=1e-6)))
    tstep = make_train_step(lambda p, b, r: tm.loss(p, b), optim.adam(1e-3, eps=1e-6))
    jstate = jtrainer.TrainState(jax.tree.map(jnp.asarray, params),
                                 joptim.adam(1e-3, eps=1e-6).init(params))
    tstate = TrainState(tparams, optim.adam(1e-3, eps=1e-6).init(tparams))
    for i in range(3):
        batch = _batch(cfg, 2, 16, seed=20 + i)
        jp, jo, jmet = jstep(jstate.params, jstate.opt_state,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(i))
        tp, to, tmet = tstep(tstate.params, tstate.opt_state,
                             {k: torch.from_numpy(v) for k, v in batch.items()}, None)
        jstate = jtrainer.TrainState(jp, jo, jstate.step + 1)
        tstate = TrainState(tp, to, tstate.step + 1)
        _close(tmet["loss"], jmet["loss"], LOSS_TOL)
    assert tstate.step == jstate.step == 3 and tstate.opt_state["step"] == 3
    for a, b in zip(jax.tree.leaves(jstate.params), tree_leaves(tstate.params)):
        _close(b, a, LOSS_TOL)


def test_default_optimizer_matches_reference():
    for arch in ["pythia-14m", "mamba2-130m", "grok-1-314b"]:
        assert (steps.default_optimizer(get_config(arch)).name
                == jsteps.default_optimizer(jget_config(arch)).name)
    big = steps.ADAFACTOR_THRESHOLD
    assert big == jsteps.ADAFACTOR_THRESHOLD
    assert steps.default_optimizer(get_config("pythia-14m"), big).name == "adafactor"
    assert steps.default_optimizer(get_config("pythia-14m"), big - 1).name == "adamw"


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab", [(0, 512), (3, 300)])
def test_lm_data_draws_the_reference_tokens(seed, vocab):
    kw = dict(vocab_size=vocab, train_tokens=5_000, test_tokens=700, seed=seed)
    ours, ref = make_synthetic_wikitext(**kw), jwikitext(**kw)
    np.testing.assert_array_equal(ours.train_tokens, ref.train_tokens)
    np.testing.assert_array_equal(ours.test_tokens, ref.test_tokens)
    for n in (1, 3):
        for a, b in zip(partition_sequence_dataset(ours.train_tokens, n),
                        jpartition_sequence(ref.train_tokens, n), strict=True):
            np.testing.assert_array_equal(a, b)
    for epoch in (0, 2):
        got = list(lm_batch_iterator(ours.train_tokens, batch_size=4, seq_len=32, seed=seed,
                                     epoch=epoch))
        want = list(jlm_batches(ref.train_tokens, batch_size=4, seq_len=32, seed=seed,
                                epoch=epoch))
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == b[key].dtype == np.int32


# ---------------------------------------------------------------------------
# the launcher and the fleets
# ---------------------------------------------------------------------------


def test_node_seed_is_stable():
    """The port's per-node seed does not depend on the process's hash salt."""
    assert ttrain.node_seed(7, "node1") == 7 + zlib.crc32(b"node1") % 1000
    assert ttrain.node_seed(0, "node0") != ttrain.node_seed(0, "node1")


ARGV = ["--simulate", "2", "--reduced", "--mode", "sync", "--epochs", "2",
        "--steps-per-epoch", "3", "--batch-size", "4", "--seq-len", "32", "--lr", "1e-3",
        "--seed", "4"]


@pytest.fixture
def same_start(monkeypatch):
    """Both packages' DecoderLM.init hand out numpy parameters per seed, the
    reference's node seed is the port's ``node_seed``, both launchers' adamw
    takes eps = 1e-6, and each package's
    ``evaluate_lm`` records the parameters it evaluates, by node (thread)."""
    monkeypatch.setattr(jtrain, "hash", lambda s: zlib.crc32(s.encode()), raising=False)
    monkeypatch.setattr(jtrain, "adamw", functools.partial(joptim.adamw, eps=1e-6))
    monkeypatch.setattr(ttrain, "adamw", functools.partial(optim.adamw, eps=1e-6))
    jcfg = jget_config("pythia-14m").reduced()
    trees = {}

    def tree(seed):
        if seed not in trees:
            trees[seed] = np_params(jbuild_model(jcfg), seed)
        return trees[seed]

    for node in ("node0", "node1"):
        tree(ttrain.node_seed(4, node))
    monkeypatch.setattr(jtransformer.DecoderLM, "init",
                        lambda self, key: jax.tree.map(jnp.asarray, tree(int(np.asarray(key)[-1]))))
    monkeypatch.setattr(ttransformer.DecoderLM, "init",
                        lambda self, rng=0, *, device="cuda": load_jax_params(
                            self, tree(int(rng)), device=device))
    final = {"jax": {}, "torch": {}}
    for pkg, mod, to_np in [("jax", jtrain, lambda p: jax.tree.map(np.asarray, p)),
                            ("torch", ttrain, lambda p: [as_numpy(x) for x in tree_leaves(p)])]:
        def recording(cfg, params, *a, _orig=mod.evaluate_lm, _pkg=pkg, _to_np=to_np, **kw):
            final[_pkg][threading.current_thread().name] = _to_np(params)
            return _orig(cfg, params, *a, **kw)

        monkeypatch.setattr(mod, "evaluate_lm", recording)
    return final


def _printed(capsys) -> dict:
    out = capsys.readouterr().out
    return {r["node"]: r for r in map(json.loads, filter(None, out.splitlines()))}


def test_simulated_main_matches_reference(same_start, capsys):
    """``main --simulate 2 --reduced`` (sync FedAvg, 2 epochs × 3 steps)
    ends with the reference's parameters
    and eval metrics. Tolerance 1e-4, the reference's for f32 models; the
    two runs differ only in f32 rounding order."""
    assert jtrain.main(ARGV) == 0
    want = _printed(capsys)
    assert ttrain.main(ARGV + ["--device", "cpu"]) == 0
    got = _printed(capsys)
    assert set(got) == set(want) == {"node0", "node1"}
    for node in want:
        for key in ("pushes", "aggregations"):
            assert got[node][key] == want[node][key] == 2
        for key in ("eval_loss", "eval_accuracy"):
            assert got[node][key] == pytest.approx(want[node][key], abs=LOSS_TOL)
        assert len(got[node]["train_loss"]) == 2
        for a, b in zip(jax.tree.leaves(same_start["jax"][node]), same_start["torch"][node],
                        strict=True):
            np.testing.assert_allclose(b, a, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=node)


def _args(**kw):
    base = dict(mode="sync", strategy="fedavg", num_nodes=2, timeout=120.0, seq_len=32,
                batch_size=4, seed=4, lr=1e-3, accum=1, steps_per_epoch=3, epochs=2,
                verbose=False, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_mixed_jax_and_torch_fleet_matches_all_jax_fleet(same_start):
    """node0 in JAX and node1 in the port share one InMemoryFolder (sync
    FedAvg, 2 rounds); both end where the all-JAX fleet's nodes end, and the
    torch node's eval metrics equal its JAX twin's, at 1e-4. (Under FedAdam
    the server step's slope near Δ = 0 is (1 − β1)/τ = 100, so rounding
    differences grow a hundredfold a round: ROADMAP Queue 3.)"""
    jcfg = jget_config("pythia-14m").reduced().replace(vocab_size=512)
    cfg = get_config("pythia-14m").reduced().replace(vocab_size=512)
    data = make_synthetic_wikitext(vocab_size=512, seed=4)
    shards = partition_sequence_dataset(data.train_tokens, 2)
    args = _args()

    def fleet(clients):
        folder = InMemoryFolder()
        res = run_threaded([lambda i=i, c=c: c(f"node{i}", folder, args, shards[i],
                                                 data.test_tokens)
                            for i, c in enumerate(clients)], names=["node0", "node1"])
        for r in res:
            assert r.error is None, r.traceback
        return {r.node_id: r.result for r in res}

    jclient = lambda *a: jtrain.run_client(jcfg, *a)  # noqa: E731
    tclient = lambda *a: ttrain.run_client(cfg, *a)  # noqa: E731
    all_jax = fleet([jclient, jclient])
    jax_final = dict(same_start["jax"])
    mixed = fleet([jclient, tclient])
    assert mixed["node1"]["aggregations"] == all_jax["node1"]["aggregations"] == 2
    for key in ("eval_loss", "eval_accuracy"):
        assert mixed["node1"][key] == pytest.approx(all_jax["node1"][key], abs=LOSS_TOL)
    pairs = [(jax.tree.leaves(jax_final["node0"]), jax.tree.leaves(same_start["jax"]["node0"])),
             (jax.tree.leaves(jax_final["node1"]), same_start["torch"]["node1"])]
    for node, (want, got) in zip(("node0", "node1"), pairs):
        for a, b in zip(want, got, strict=True):
            np.testing.assert_allclose(b, a, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=node)


def test_one_silo_on_a_disk_folder(tmp_path, capsys):
    """``--node-id`` runs one real silo against a folder URI; alone in an
    async fleet it pushes every epoch and never aggregates."""
    store = str(tmp_path / "exp")
    assert ttrain.main(["--node-id", "silo0", "--num-nodes", "2", "--store", store,
                        "--reduced", "--epochs", "2", "--steps-per-epoch", "2",
                        "--batch-size", "2", "--seq-len", "16", "--device", "cpu"]) == 0
    (result,) = _printed(capsys).values()
    assert result["node"] == "silo0" and result["pushes"] == 2 and result["aggregations"] == 0
    assert np.isfinite(result["eval_loss"]) and 0 <= result["eval_accuracy"] <= 1
    assert any(k.startswith("latest/") for k in jcore.make_folder(store).keys())
