"""All eight strategies of the port against ``repro.core.strategies``, over
stateful three-round sequences on the CPU.

Both packages get the same updates: own as a numpy tree (what a node pushes),
peers as FlatUpdates each package decodes from the same wire blobs. The
tolerance is rtol 1e-5 / atol 1e-6: the port's CPU combine sums in another
order than numpy's BLAS matvec.
"""
import numpy as np
import pytest
import torch

from repro.core import serialize as jser
from repro.core import strategies as jstrat
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro_torch.core import serialize as tser
from repro_torch.core import strategies as tstrat
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.tree import as_numpy, tree_leaves

RTOL, ATOL = 1e-5, 1e-6


def _tree(rng, scale=1.0):
    return {"enc": {"w": (rng.normal(size=(17, 6)) * scale).astype(np.float32),
                    "norm": {"scale": rng.normal(size=(6,)).astype(np.float32)}},
            "head": {"b": rng.normal(size=(3,)).astype(np.float32),
                     "w": rng.normal(size=(6, 3)).astype(np.float32)}}


def _rounds(seed, n_peers=3, rounds=3, tree=_tree):
    """[(own, [peer blob, ...]), ...] with counters, example counts and lease
    epochs that vary across peers and rounds."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        own = dict(params=tree(rng), num_examples=int(rng.integers(5, 50)),
                   node_id="own", counter=2 * r + 1, lease_epoch=0)
        peers = []
        for j in range(n_peers):
            upd = JNodeUpdate(tree(rng), int(rng.integers(0, 60)), f"peer{j}",
                              counter=2 * r + int(rng.integers(-2, 2)),
                              lease_epoch=int(j == 1 and r > 0))
            peers.append(jser.serialize_update(upd))
        out.append((own, peers))
    return out


def _decode(ser, blob, specs):
    """As the store decodes: a flat update, or the tree for int/f64 leaves."""
    try:
        return ser.deserialize_update_flat(blob, specs)
    except ser.FlatDecodeUnsupported:
        return ser.deserialize_update(blob)


def _run(make_j, make_t, rounds):
    """Feed both packages' strategies the same sequence; compare each round."""
    js, ts = make_j(), make_t()
    specs_j, specs_t = {}, {}
    for r, (own, blobs) in enumerate(rounds):
        j_out = js.aggregate(JNodeUpdate(**own), [_decode(jser, b, specs_j) for b in blobs])
        t_out = ts.aggregate(NodeUpdate(**own), [_decode(tser, b, specs_t) for b in blobs])
        jl, tl = tree_leaves(j_out), tree_leaves(t_out)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            b = as_numpy(b)
            assert np.asarray(a).dtype == b.dtype, f"round {r}"
            np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{js.name} round {r}")
    return js, ts


CASES = {
    "fedavg": (jstrat.FedAvg, tstrat.FedAvg, {}),
    "fedavgm": (jstrat.FedAvgM, tstrat.FedAvgM, dict(server_lr=0.7, momentum=0.8)),
    "fedadam": (jstrat.FedAdam, tstrat.FedAdam, dict(server_lr=0.3, beta1=0.8, beta2=0.95, tau=1e-2)),
    "fedyogi": (jstrat.FedYogi, tstrat.FedYogi, dict(server_lr=0.3, beta1=0.8, beta2=0.95, tau=1e-2)),
    "fedadagrad": (jstrat.FedAdagrad, tstrat.FedAdagrad, dict(server_lr=0.3, tau=1e-2)),
    "fedasync": (jstrat.FedAsync, tstrat.FedAsync, dict(alpha=0.6, a=0.5)),
    "fedbuff": (jstrat.FedBuff, tstrat.FedBuff, dict(buffer_size=3)),
    "partial_fedavg": (jstrat.PartialFedAvg, tstrat.PartialFedAvg, dict(shared_pattern="^enc/")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_strategy_matches_reference_over_three_rounds(name):
    jcls, tcls, kw = CASES[name]
    assert jcls.name == tcls.name == name
    _run(lambda: jcls(**kw), lambda: tcls(**kw, device="cpu"), _rounds(sorted(CASES).index(name)))


@pytest.mark.parametrize("name", ["fedadam", "fedyogi", "fedadagrad"])
def test_fused_server_step_matches_reference_kernel_path(name):
    """use_kernel=True: the reference's fed_opt_flat chain vs the port's op."""
    jcls, tcls, kw = CASES[name]
    _run(lambda: jcls(**kw, use_kernel=True), lambda: tcls(**kw, use_kernel=True, device="cpu"),
         _rounds(7))


@pytest.mark.parametrize("staleness_fn,epoch_a", [("poly", 1.0), ("hinge", 0.0), ("const", 2.0)])
def test_fedasync_discounts_match_reference(staleness_fn, epoch_a):
    kw = dict(alpha=0.5, staleness_fn=staleness_fn, a=0.7, b=1, epoch_a=epoch_a)
    _run(lambda: jstrat.FedAsync(**kw), lambda: tstrat.FedAsync(**kw, device="cpu"),
         _rounds(11, n_peers=4))


def test_fedbuff_waits_for_buffer_then_matches():
    rounds = _rounds(13, n_peers=1, rounds=4)
    js, ts = _run(lambda: jstrat.FedBuff(buffer_size=3),
                  lambda: tstrat.FedBuff(buffer_size=3, device="cpu"), rounds)
    assert set(js._pending) == set(ts._pending)


def test_partial_fedavg_families_and_exact_personal_leaves():
    """Family selection, and int64/float64 personal leaves passed through
    bit-exact (never rounded through the f32 flat)."""
    def tree(rng):
        t = _tree(rng)
        t["counts"] = rng.integers(0, 2**40, size=(4,)).astype(np.int64)
        t["precise"] = rng.normal(size=(3,)).astype(np.float64)
        return t

    _run(lambda: jstrat.PartialFedAvg(families="norms"),
         lambda: tstrat.PartialFedAvg(families="norms", device="cpu"), _rounds(17, tree=tree))
    rounds = _rounds(19, tree=tree)
    own = NodeUpdate(**rounds[0][0])
    out = tstrat.PartialFedAvg(shared_pattern="^head/", device="cpu").aggregate(
        own, [tser.deserialize_update(b) for b in rounds[0][1]])
    np.testing.assert_array_equal(out["counts"], own.params["counts"])
    np.testing.assert_array_equal(out["precise"], own.params["precise"])


@pytest.mark.parametrize("name", ["fedavgm", "fedadam"])
def test_strategy_state_round_trips_between_packages(name):
    """A port node's recovery blob restores the reference's strategy, and the
    reverse: both continue on the same trajectory."""
    jcls, tcls, kw = CASES[name]
    rounds = _rounds(23)
    js, ts = _run(lambda: jcls(**kw), lambda: tcls(**kw, device="cpu"), rounds[:2])
    j2, t2 = jcls(**kw), tcls(**kw, device="cpu")
    j2.load_state_dict(tser.deserialize_strategy_state(
        tser.serialize_strategy_state("n", name, 2, ts.state_dict()))[0])
    t2.load_state_dict(jser.deserialize_strategy_state(
        jser.serialize_strategy_state("n", name, 2, js.state_dict()))[0])
    _run(lambda: j2, lambda: t2, rounds[2:])


def test_reuse_output_views_one_buffer():
    rounds = _rounds(29)
    s = tstrat.FedAvg(reuse_output=True, device="cpu")
    own, blobs = rounds[0]
    peers = [tser.deserialize_update(b) for b in blobs]
    a = s.aggregate(NodeUpdate(**own), peers)
    b = s.aggregate(NodeUpdate(**own), peers)
    assert a["enc"]["w"].data_ptr() == b["enc"]["w"].data_ptr()
    fresh = tstrat.FedAvg(device="cpu").aggregate(NodeUpdate(**own), peers)
    assert fresh["enc"]["w"].data_ptr() != a["enc"]["w"].data_ptr()


def test_stack_rows_reupload_only_changed_peers():
    """A peer whose flat is the same object as last round is not re-copied."""
    rounds = _rounds(31, rounds=1)
    own, blobs = rounds[0]
    specs = {}
    peers = [tser.deserialize_update_flat(b, specs) for b in blobs]
    s = tstrat.FedAvg(device="cpu")
    s.aggregate(NodeUpdate(**own), peers)
    stack = s._stack._buf
    peers[1].flat[:] = 0.0  # mutate behind the cache's back: an unchanged id is trusted
    s.aggregate(NodeUpdate(**own), peers)
    assert s._stack._buf is stack
    assert float(stack[2, 0]) != 0.0
    peers[1] = tser.deserialize_update_flat(blobs[1], specs)  # a new object is re-copied
    peers[1].flat[:] = 0.0
    s.aggregate(NodeUpdate(**own), peers)
    assert float(stack[2, :peers[1].spec.num_params].abs().max()) == 0.0


def test_stack_rows_are_padded_for_vector_loads():
    own, blobs = _rounds(37, rounds=1)[0]
    s = tstrat.FedAvg(device="cpu")
    s.aggregate(NodeUpdate(**own), [tser.deserialize_update(b) for b in blobs])
    assert s._stack._buf.stride(0) % 32 == 0


def test_get_strategy_and_cuda_default():
    assert set(tstrat.STRATEGIES) == set(jstrat.STRATEGIES)
    assert isinstance(tstrat.get_strategy("fedyogi", device="cpu"), tstrat.FedYogi)
    with pytest.raises(KeyError):
        tstrat.get_strategy("nope")
    assert tstrat.FedAvg(device="cpu").device == torch.device("cpu")
