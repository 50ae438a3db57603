"""Shared helpers of the parity tests (tests/test_torch_*.py): inputs drawn
with numpy from a seed, in the reference's parameter layout, handed to both
packages."""
import jax
import numpy as np

from repro_torch.core.tree import as_numpy


def np_params(jax_model, seed: int) -> dict:
    """Parameters in ``jax_model``'s layout (found without running its init),
    drawn with numpy: He-scaled weights, perturbed biases and GroupNorm
    affines."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        if path.endswith("/w"):
            return rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        return (1.0 if path.endswith("/scale") else 0.0) + 0.1 * rng.normal(size=shape)

    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(jax.tree_util.keystr(p, simple=True, separator="/"),
                          s.shape).astype(np.float32), shapes)


def assert_rel_close(got, want, msg: str = "", tol: float = 1e-4) -> None:
    """|got − want| ≤ tol · max|want|: the reference's f32 tolerance (1e-4)
    of the largest magnitude. ``got`` a tensor or array, ``want`` an array."""
    got, want = as_numpy(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{msg}: max abs err {err * scale} = {err} of max |want| {scale}"
