"""``python -m repro_torch.launch.dryrun`` against ``repro.launch.dryrun``.

The dry run needs a ``fake`` process group, which lives for its process, so
it runs in one child process here (the group never reaches another test on
this worker): every architecture's ``reduced()`` config at a small train,
prefill and decode shape on a fake (2, 4) mesh, granite-3-2b on (2, 2, 2),
a redistribution of known size on a fake world of 4, and the CLI's exit code
on a failed combination. The records must be ``ok``, carry the reference's
keys, and agree with the reference's parameter, token and model-flop
arithmetic.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro_torch.configs import ARCH_IDS, PAPER_IDS

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ARCH_IDS + PAPER_IDS
# (name, seq, batch, kind): small enough for the CPU
SHAPES = [("train_s", 64, 8, "train"), ("prefill_s", 128, 4, "prefill"),
          ("decode_s", 128, 8, "decode")]

CHILD = r"""
import json, logging, sys
logging.disable(logging.WARNING)
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import costs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import InputShape

archs, shapes, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
recs = []
for arch in archs:
    for name, seq, batch, kind in shapes:
        recs.append(D.run_one(arch, InputShape(name, seq, batch, kind), multi_pod=False,
                              reduced=True, mesh_shape=(2, 4), microbatches=2, verbose=False))
recs.append(D.run_one("granite-3-2b", InputShape("prefill_s", 128, 4, "prefill"),
                      multi_pod=False, reduced=True, mesh_shape=(2, 2, 2), verbose=False))
# a known redistribution on a fake world of 4: (8, 64) f32 partial sums → replicated
mesh = D.fake_mesh((4,), ("model",))
a = distribute_tensor(torch.zeros(8, 64), mesh, [Shard(1)], src_data_rank=None)
b = distribute_tensor(torch.zeros(64, 16), mesh, [Shard(0)], src_data_rank=None)
costs, _ = C.step_costs(lambda a, b: (a @ b).redistribute(mesh, [Replicate()]), a, b)
coll = C.collective_bytes(costs)
rc = D.main(["--arch", "no-such-arch", "--shape", "decode_32k"])
json.dump({"records": recs, "collectives": coll, "bad_arch_rc": rc}, open(out, "w"))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(ARCHS), json.dumps(SHAPES),
                           str(out)], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without keeping the XLA_FLAGS line
    its import sets (512 host devices) for this process's later JAX work."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def _reference_record_keys() -> set:
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "record":
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in the reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_records_match_reference_arithmetic(dry, arch):
    jd = _reference_dryrun()
    jcfg = jget_config(arch).reduced()
    p_shapes = jspecs.params_specs(jcfg)
    n_params = jd.count_params(p_shapes)
    frac = jd.active_param_fraction(jcfg, p_shapes)
    keys = _reference_record_keys()
    recs = {r["shape"]: r for r in dry["records"] if r["arch"] == arch and r["mesh"] == "2x4"}
    assert set(recs) == {s[0] for s in SHAPES}
    for name, seq, batch, kind in SHAPES:
        rec = recs[name]
        assert rec["ok"] and set(rec) == keys, rec
        shape = jspecs.InputShape(name, seq, batch, kind)
        data = jspecs.input_specs(jcfg, shape)
        n_tokens = batch if kind == "decode" else data["tokens"].shape[0] * data["tokens"].shape[1]
        mf = (jd.C.model_flops_train if kind == "train" else jd.C.model_flops_infer)(
            n_params, n_tokens, frac)
        assert (rec["n_params"], rec["active_fraction"], rec["n_tokens"]) == \
            (n_params, round(frac, 4), n_tokens)
        assert rec["model_flops"] == pytest.approx(mf, rel=1e-12)
        assert rec["chips"] == 8 and rec["kind"] == kind
        assert rec["flops_global"] > 0 and rec["bytes_global"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        mem = rec["memory_analysis"]
        assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0


def test_dryrun_on_a_pod_mesh(dry):
    (rec,) = [r for r in dry["records"] if r["mesh"] == "2x2x2"]
    assert rec["ok"] and rec["chips"] == 8 and rec["arch"] == "granite-3-2b"
    flat = [r for r in dry["records"] if r["mesh"] == "2x4" and r["arch"] == "granite-3-2b"
            and r["shape"] == "prefill_s"][0]
    assert rec["flops_global"] == flat["flops_global"]  # global work is the mesh's business


def test_collective_bytes_of_a_known_redistribution(dry):
    """(8, 64) @ (64, 16) sharded on the contracted dim leaves (8, 16) f32
    partial sums; replicating them is one all-reduce of 512 bytes a rank."""
    assert dry["collectives"]["all-reduce"] == 8 * 16 * 4
    assert dry["collectives"]["total"] == 8 * 16 * 4


def test_dryrun_cli_fails_on_a_failed_combination(dry):
    assert dry["bad_arch_rc"] == 1
