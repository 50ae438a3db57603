"""Parameter-tree utilities used across the federated core.

A parameter tree is a nested dict (lists and tuples are allowed too) whose
leaves are torch tensors or numpy arrays. The port keeps the JAX package's
tree layout so that the wire format and ``LeafSpec.key`` match it byte for
byte:

* leaves are ordered as ``jax.tree_util`` orders them — **dict keys sorted at
  every level** (``torch.utils._pytree`` would use insertion order);
* a leaf's path renders as ``'a/b/0/c'`` (``path_str``);
* ``LeafSpec.key`` hashes ``repr((paths, shapes, dtype names))`` with shapes
  as tuples of Python ints and dtype names as numpy spells them.

``LeafSpec`` is the contract of the flat-vector federation hot path: the
paths/shapes/dtypes/offsets of a model's leaves, computed once per structure
and shared by every flat vector of that layout. Flat vectors are numpy on the
host (the wire side) and torch tensors on the device (the aggregation side);
``flatten_into`` and ``unflatten`` take either.
"""
from __future__ import annotations

import hashlib
import re
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

PyTree = Any

# Dtypes whose every value survives a float32 round-trip (see the reference).
_F32_EXACT = frozenset(
    {"float32", "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"}
)
# Narrow floats numpy has no type of its own for (the reference takes them
# from ml_dtypes, a JAX dependency the port does without). The port keeps
# them as torch tensors and names; on the host side of numpy they are f32.
NARROW_FLOATS = frozenset({"bfloat16", "float8_e4m3fn", "float8_e5m2"})


# --------------------------------------------------------------------------
# Flattening in JAX's canonical order
# --------------------------------------------------------------------------

_LEAF = "*"


def _flatten(tree: PyTree, path: tuple, out: list) -> Any:
    """Append (path, leaf) pairs to ``out``; return the structure (treedef)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys), tuple(_flatten(tree[k], path + (k,), out) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten(x, path + (i,), out) for i, x in enumerate(tree)))
    if tree is None:
        return ("none",)
    out.append((path, tree))
    return _LEAF


def tree_flatten_with_path(tree: PyTree) -> tuple[list[tuple[tuple, Any]], Any]:
    """-> ([(path, leaf), ...] in canonical order, treedef)."""
    out: list = []
    treedef = _flatten(tree, (), out)
    return out, treedef


def tree_structure(tree: PyTree) -> Any:
    return tree_flatten_with_path(tree)[1]


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_unflatten(treedef: Any, leaves: Sequence) -> PyTree:
    it = iter(leaves)

    def build(td):
        if td == _LEAF:
            return next(it)
        kind = td[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        if kind == "none":
            return None
        children = [build(c) for c in td[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten_with_path(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(leaf, *(o[i] for o in others))
                                    for i, (_, leaf) in enumerate(leaves)])


def path_str(path: tuple) -> str:
    """Render a key path as 'a/b/0/c'."""
    return "/".join(str(k) for k in path)


# --------------------------------------------------------------------------
# dtypes and leaf conversion (torch <-> numpy)
# --------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype, numpy dtype or dtype name ("float32",
    "bfloat16", ...): what ``LeafSpec.key`` hashes."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype in NARROW_FLOATS:
        return dtype
    return np.dtype(dtype).name  # an ml_dtypes dtype of a JAX leaf names itself


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype_name(dtype))


def as_numpy(leaf) -> np.ndarray:
    """Host numpy view/copy of a leaf's values. Numpy has no bf16/fp8 type,
    so those tensors widen to f32 (exactly); other dtypes are kept."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return t.float().numpy() if dtype_name(t.dtype) in NARROW_FLOATS else t.numpy()
    return np.asarray(leaf)


def as_host(leaf):
    """Host copy of a leaf that keeps its dtype: numpy, except bf16/fp8
    tensors, which stay CPU tensors (numpy has no type for them)."""
    if isinstance(leaf, torch.Tensor) and dtype_name(leaf.dtype) in NARROW_FLOATS:
        return leaf.detach().cpu()
    return as_numpy(leaf)


def as_tensor(leaf) -> torch.Tensor:
    """Tensor of a leaf (host numpy becomes a CPU tensor sharing memory where
    torch has the dtype; a JAX-side bf16/fp8 numpy leaf widens to f32)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name in NARROW_FLOATS:
        arr = arr.astype(np.float32)
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d leaf 1-d)
        arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr)


def _shape_dtype(leaf) -> tuple[tuple[int, ...], str]:
    shape, dtype = getattr(leaf, "shape", None), getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        arr = np.asarray(leaf)
        shape, dtype = arr.shape, arr.dtype
    return tuple(int(s) for s in shape), dtype_name(dtype)


class LeafSpec:
    """Flat layout of one tree structure: paths, shapes, dtypes, offsets.

    Immutable once built and content-hashed (``key``), so two specs with
    equal keys describe byte-compatible flat vectors even when built in
    different stores, processes — or packages: the key equals the JAX
    package's for the same tree.
    """

    def __init__(self, paths, shapes, dtypes, treedef):
        self.paths: tuple[str, ...] = tuple(paths)
        self.shapes: tuple[tuple[int, ...], ...] = tuple(
            tuple(int(d) for d in s) for s in shapes)
        self.dtypes: tuple[str, ...] = tuple(dtype_name(d) for d in dtypes)
        self.treedef = treedef
        self.sizes: tuple[int, ...] = tuple(int(np.prod(s)) for s in self.shapes)
        offsets = np.zeros(len(self.sizes) + 1, np.int64)
        np.cumsum(self.sizes, out=offsets[1:])
        self.offsets: np.ndarray = offsets[:-1]
        self.bounds: np.ndarray = offsets  # offsets plus the total, for searchsorted
        self.num_params: int = int(offsets[-1])
        self.index: dict[str, int] = {p: i for i, p in enumerate(self.paths)}
        self._family_views: dict[tuple, "FamilyView"] = {}
        # True when flatten→unflatten is value-exact (every leaf f32-embeddable)
        self.f32_exact: bool = all(d in _F32_EXACT for d in self.dtypes)
        self.key: str = hashlib.sha256(
            repr((self.paths, self.shapes, self.dtypes)).encode()
        ).hexdigest()[:16]

    @classmethod
    def of(cls, tree: PyTree) -> "LeafSpec":
        leaves_with_paths, treedef = tree_flatten_with_path(tree)
        paths, shapes, dtypes = [], [], []
        for path, leaf in leaves_with_paths:
            shape, dtype = _shape_dtype(leaf)
            paths.append(path_str(path))
            shapes.append(shape)
            dtypes.append(dtype)
        return cls(paths, shapes, dtypes, treedef)

    def compatible(self, other: "LeafSpec | None") -> bool:
        return other is not None and (other is self or other.key == self.key)

    def describes(self, tree: PyTree) -> bool:
        """Same structure; shape drift is caught by ``flatten``'s size check."""
        return tree_structure(tree) == self.treedef

    def _leaves(self, tree: PyTree) -> list:
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.sizes):
            raise ValueError(f"{len(leaves)} leaves vs spec's {len(self.sizes)}")
        return leaves

    def flatten(self, tree: PyTree) -> np.ndarray:
        """One contiguous host f32 vector in spec order. Per-leaf sizes are
        validated, so a shape permutation cannot produce a mislaid vector."""
        parts = []
        for n, leaf in zip(self.sizes, self._leaves(tree)):
            arr = np.asarray(as_numpy(leaf), np.float32)
            if arr.size != n:
                raise ValueError(f"leaf size {arr.size} vs spec's {n}")
            parts.append(arr.reshape(-1))
        return np.concatenate(parts) if parts else np.zeros((0,), np.float32)

    def flatten_into(self, tree: PyTree, out: "np.ndarray | torch.Tensor"):
        """Flatten ``tree`` into a caller-provided f32 buffer: a host numpy
        vector, or a tensor (e.g. one row of the device stack) — each leaf is
        copied straight into its slice, across devices if need be."""
        leaves = self._leaves(tree)
        if tuple(out.shape) != (self.num_params,):
            raise ValueError(f"out shape {tuple(out.shape)} vs ({self.num_params},)")
        for o, n, leaf in zip(self.offsets, self.sizes, leaves):
            size = leaf.numel() if isinstance(leaf, torch.Tensor) else np.size(leaf)
            if size != n:
                raise ValueError(f"leaf size {size} vs spec's {n}")
            if isinstance(out, torch.Tensor):
                out[o:o + n].copy_(as_tensor(leaf).reshape(-1))
            else:
                out[o:o + n] = as_numpy(leaf).reshape(-1)
        return out

    def unflatten(self, vec: "np.ndarray | torch.Tensor") -> PyTree:
        """Flat vector → tree with the original shapes/dtypes. A numpy vector
        gives numpy leaves (bf16/fp8 leaves: CPU tensors), a tensor gives
        tensor leaves on its device. Float32 leaves are *views* into ``vec``
        (zero copy); treat them as read-only."""
        if isinstance(vec, torch.Tensor):
            vec = vec.reshape(-1)
            if vec.numel() != self.num_params:
                raise ValueError(f"{vec.numel()} params vs spec's {self.num_params}")
            leaves = [vec[o:o + n].to(torch_dtype(d)).reshape(s)
                      for o, n, d, s in zip(self.offsets, self.sizes, self.dtypes, self.shapes)]
        else:
            vec = np.asarray(vec).reshape(-1)
            if vec.size != self.num_params:
                raise ValueError(f"{vec.size} params vs spec's {self.num_params}")
            leaves = [torch.from_numpy(vec[o:o + n]).to(torch_dtype(d)).reshape(s)
                      if d in NARROW_FLOATS else np.asarray(vec[o:o + n], dtype=d).reshape(s)
                      for o, n, d, s in zip(self.offsets, self.sizes, self.dtypes, self.shapes)]
        return tree_unflatten(self.treedef, leaves)

    def empty_flat(self) -> np.ndarray:
        return np.empty((self.num_params,), np.float32)

    def family_view(self, families: "str | Sequence[str] | Mapping[str, str]") -> "FamilyView":
        """Sub-vector view of the named leaf families (cached per selector)."""
        resolved = resolve_family_patterns(families)
        cache_key = tuple(resolved.items())
        view = self._family_views.get(cache_key)
        if view is None:
            view = self._family_views[cache_key] = FamilyView(self, resolved)
        return view

    def __repr__(self) -> str:
        return (f"LeafSpec(leaves={len(self.paths)}, params={self.num_params}, "
                f"key={self.key})")


# --------------------------------------------------------------------------
# Leaf families: named subsets of a model's leaves, selected by path pattern
# --------------------------------------------------------------------------

FAMILY_PATTERNS: dict[str, str] = {
    "adapters": r"(^|/)(lora_[ab]|adapter[^/]*)(/|$)",
    "embeddings": r"(^|/)(embed|unembed)(/|$)",
    "norms": r"(^|/)[a-z_]*norm[0-9]*(/|$)",
}


def register_family(name: str, pattern: str) -> None:
    """Register (or override) a named leaf family pattern."""
    re.compile(pattern)  # fail fast on a malformed regex
    FAMILY_PATTERNS[name] = pattern


def resolve_family_patterns(
    families: str | Sequence[str] | Mapping[str, str],
) -> dict[str, str]:
    """Normalize a family selector into an ordered ``{name: pattern}`` dict."""
    if isinstance(families, str):
        families = (families,)
    if isinstance(families, Mapping):
        return {str(n): str(p) for n, p in families.items()}
    out: dict[str, str] = {}
    for name in families:
        if name not in FAMILY_PATTERNS:
            raise KeyError(
                f"unknown leaf family {name!r}; registered: {sorted(FAMILY_PATTERNS)} "
                "(register_family adds more)")
        out[name] = FAMILY_PATTERNS[name]
    return out


class FamilyView:
    """Flat sub-vector view of a LeafSpec restricted to named leaf families.

    A leaf belongs to the first selected family whose pattern matches its
    path. ``mask`` / ``indices`` are host numpy over the spec's flat vector;
    ``pattern`` is the single equivalent regex.
    """

    def __init__(self, spec: LeafSpec, patterns: Mapping[str, str]):
        if not patterns:
            raise ValueError("family selector is empty")
        self.spec = spec
        self.names: tuple[str, ...] = tuple(patterns)
        compiled = {n: re.compile(p) for n, p in patterns.items()}
        leaf_names = [next((n for n, rx in compiled.items() if rx.search(path)), None)
                      for path in spec.paths]
        self.leaf_names: tuple[str | None, ...] = tuple(leaf_names)
        self.leaf_mask: tuple[bool, ...] = tuple(f is not None for f in leaf_names)
        self.paths: tuple[str, ...] = tuple(
            p for p, f in zip(spec.paths, leaf_names) if f is not None)
        mask = np.zeros(spec.num_params, bool)
        fam_spans: dict[str, list[tuple[int, int]]] = {n: [] for n in self.names}
        for fam, off, size in zip(leaf_names, spec.offsets, spec.sizes):
            if fam is not None:
                mask[off:off + size] = True
                fam_spans[fam].append((int(off), int(size)))
        empty = [n for n, spans in fam_spans.items() if not spans]
        if empty:
            raise ValueError(
                f"leaf families {empty} match no leaf of {spec!r}; "
                f"paths: {list(spec.paths)[:8]}...")
        self.mask: np.ndarray = mask
        self.indices: np.ndarray = np.flatnonzero(mask).astype(np.int64)
        self.num_params: int = int(self.indices.size)
        self._fam_spans = fam_spans
        self._fam_indices: dict[str, np.ndarray] = {}
        self.pattern: str = "|".join(f"(?:{p})" for p in patterns.values())
        self.key: str = hashlib.sha256(
            repr((spec.key, tuple(patterns.items()))).encode()).hexdigest()[:16]

    def indices_of(self, name: str) -> np.ndarray:
        """Sorted flat indices of one family's parameters."""
        idx = self._fam_indices.get(name)
        if idx is None:
            spans = self._fam_spans[name]
            idx = (np.concatenate([np.arange(o, o + s, dtype=np.int64) for o, s in spans])
                   if spans else np.zeros((0,), np.int64))
            idx.sort()
            self._fam_indices[name] = idx
        return idx

    def extract(self, flat: np.ndarray) -> np.ndarray:
        """Gather the view's sub-vector out of a full flat vector (copy)."""
        return np.asarray(flat)[self.indices]

    def scatter(self, sub: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Scatter a sub-vector back into a full flat vector, in place."""
        if sub.shape != (self.num_params,):
            raise ValueError(f"sub shape {sub.shape} vs ({self.num_params},)")
        out[self.indices] = sub
        return out

    def __repr__(self) -> str:
        return (f"FamilyView({'+'.join(self.names)}, leaves={len(self.paths)}, "
                f"params={self.num_params}/{self.spec.num_params})")


# --------------------------------------------------------------------------
# Leaf helpers
# --------------------------------------------------------------------------


def tree_to_numpy(tree: PyTree) -> PyTree:
    """Device→host copy; the wire and the store live on the host. Leaves
    become numpy arrays, bf16/fp8 leaves CPU tensors (``as_host``)."""
    return tree_map(as_host, tree)


def tree_size_bytes(tree: PyTree) -> int:
    """Bytes of the tree's leaves in their own dtypes (a bf16 leaf counts 2
    bytes an entry, as the reference counts it, though it ships as f32)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            arr = np.asarray(leaf)
            total += arr.size * arr.dtype.itemsize
    return total


def tree_weighted_sum(trees: Sequence[PyTree], weights: Sequence[float]) -> PyTree:
    """sum_i weights[i] * trees[i], leafwise, in the reference's order (numpy
    or tensor leaves; a leaf keeps its kind and dtype)."""
    if len(trees) != len(weights):
        raise ValueError(f"{len(trees)} trees vs {len(weights)} weights")
    if not trees:
        raise ValueError("empty aggregation")

    def _leaf(*leaves):
        acc = leaves[0] * weights[0]
        for leaf, w in zip(leaves[1:], weights[1:]):
            acc = acc + leaf * w
        return acc

    return tree_map(_leaf, *trees)


def tree_weighted_mean(trees: Sequence[PyTree], weights: Sequence[float]) -> PyTree:
    """Weighted mean with weights normalized to sum to 1 (FedAvg, eq. 1)."""
    total = float(sum(weights))
    if total <= 0:
        raise ValueError(f"non-positive total weight {total}")
    return tree_weighted_sum(trees, [float(w) / total for w in weights])
