"""What the benchmark's processes load: nothing named exactly ``jax``,
``jaxlib``, ``flax`` or ``repro``, and the reference nothing of the program."""
from __future__ import annotations

import subprocess
import sys

from portbench import harness

ROOT = str(harness.ROOT)


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=240,
                         env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return {m.split(".", 1)[0] for m in out.stdout.split()}


def test_the_run_loads_no_jax_and_no_jax_package():
    top = _loaded("import portbench.run as r\nr._environment()\n"
                  "import portbench.drivers.federated_training, portbench.drivers.serving\n"
                  "from repro_torch.api import connect, serve\n"
                  "from repro_torch.core import AsyncFederatedNode, FederatedCallback\n"
                  "from repro_torch.training import Trainer\n"
                  "from repro_torch.models.cnn import ResNet\n"
                  "from repro_torch.serving import ServingNode")
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import portbench.reference.resnet18, portbench.reference.mamba2, "
                  "portbench.reference.wire, portbench.counts.roofline, "
                  "portbench.counts.mamba2, portbench.counts.resnet18, "
                  "portbench.traffic.cifar, portbench.traffic.requests")
    assert not top & {"repro_torch", *harness.FORBIDDEN_MODULES}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_loaded()
