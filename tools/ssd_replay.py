"""Replays ``chip_smoke.py`` up to its ``ssd_scan`` phases, with the same
generator draws, and takes the bf16 S = 8,192 check apart: the kernel's y
against its CPU emulation (``ssd_cluster_ref``), the plain f32 version and
the plain f64 version, each error over what the check's tolerance allows
at that element, and the twelve worst elements. Stops after the
``ssd_kernels`` phase (times and the build report).

    python3 tools/ssd_replay.py      # on the card, from the repository root
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_cluster_ref  # noqa: E402

TOL = 2e-2  # the check's bf16 rtol; its atol is TOL * min(1, max|want|)
calls = []
kernel_ssd = sk.ssd


def recorded_ssd(x, dA, Bm, Cm, *, chunk, initial_state=None, state_out=None):
    init = None if initial_state is None else initial_state.clone()
    y, state = kernel_ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=initial_state,
                          state_out=state_out)
    calls.append((x, dA, Bm, Cm, init, y.clone(), chunk))
    return y, state


class Stop(Exception):
    pass


def report(x, dA, Bm, Cm, init, y, chunk) -> dict:
    B, S, H, _ = x.shape
    wide = (B, S, H, Bm.shape[-1])
    c = [t.cpu() for t in (x, dA, Bm, Cm, init)]

    def plain(*t):
        return ssd_chunked(t[0], t[1], t[2][:, :, None].expand(wide),
                           t[3][:, :, None].expand(wide), chunk, initial_state=t[4])[0]

    want = plain(*(t.double() for t in c))
    runs = {"kernel": y.cpu().double(), "emulation": ssd_cluster_ref(*c[:4], chunk, c[4])[0].double(),
            "plain_f32": plain(*c).double()}
    atol = TOL * min(1.0, float(want.abs().max()))
    allowed = atol + TOL * want.abs()
    out = {"max|want|": float(want.abs().max()), "atol": atol}
    for name, got in runs.items():
        ratio = (got - want).abs() / allowed
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "max_ratio": float(ratio.max()), "n_over": int((ratio > 1).sum())}
    out["kernel_vs_emulation_max_abs"] = float((runs["kernel"] - runs["emulation"]).abs().max())
    ratio = (runs["kernel"] - want).abs() / allowed
    out["worst"] = []
    for i in torch.topk(ratio.flatten(), 12).indices.tolist():
        b, s, h, p = (int(v) for v in torch.unravel_index(torch.tensor(i), ratio.shape))
        out["worst"].append({"s": s, "h": h, "p": p, "want": float(want[b, s, h, p]),
                             "ratio": float(ratio[b, s, h, p]),
                             **{name: float(t[b, s, h, p]) for name, t in runs.items()}})
    return out


def check_ssd(dev, gen):
    failed = False
    try:
        result = checks(dev, gen)
        print("check_ssd passed", flush=True)
    except AssertionError as e:
        print("check_ssd failed:", e, flush=True)
        failed = True
    for x, dA, Bm, Cm, init, y, chunk in calls:
        if x.dtype == torch.bfloat16 and x.shape[1] == 8192:
            print(json.dumps(report(x, dA, Bm, Cm, init, y, chunk)), flush=True)
    if failed:
        raise Stop()
    return result


def emit(phase, **fields):
    chip_emit(phase, **fields)
    if phase == "ssd_kernels":
        raise Stop()


if __name__ == "__main__":
    checks, chip_emit = cs.check_ssd, cs.emit
    sk.ssd, cs.check_ssd, cs.emit = recorded_ssd, check_ssd, emit
    try:
        cs.main()
    except Stop:
        print("stopped after the ssd phases")
