"""The port's checkpoints (``repro_torch.train.checkpoint``) vs the JAX
package's, on the CPU.

The two share one layout: ``step_%09d/leaf_%05d.npy`` in JAX's leaf
order, ``manifest.json`` with the same ``step``, ``n_leaves`` and
``leaves`` (its ``treedef`` string is each package's own) and the
``.COMMITTED`` marker written last.  Each package restores the other's
checkpoints exactly (bitwise), bf16 and int8 leaves included.  A leaf
file's bytes are the reference's, except a bf16 leaf's header, which
says ``|V2`` where ``ml_dtypes`` writes ``<V2`` (numpy reads both as
2-byte void, and its data bytes are equal).  The reference's own
checkpoint tests (tests/test_checkpoint_trainer.py) are mirrored on the
port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JC
from repro_torch.train import checkpoint as C
from repro_torch.train.optimizer import tree_leaves


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"a": rng.normal(size=(8, 3)).astype(np.float32),
                       "nested": {"b": rng.normal(size=(5, 4)),
                                  "c": np.asarray([seed], np.int32)}},
            "opt": {"count": np.asarray(seed + 3, np.int32),
                    "m": {"q": rng.integers(-127, 128, (4, 6))
                          .astype(np.int8),
                          "scale": rng.uniform(size=(4,))
                          .astype(np.float32)}}}


def _jax_tree(t):
    """b in bf16, the rest as it is."""
    out = jax.tree.map(jnp.asarray, t)
    out["params"]["nested"]["b"] = jnp.asarray(t["params"]["nested"]["b"],
                                               jnp.bfloat16)
    return out


def _torch_tree(t):
    out = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)
    out["params"]["nested"]["b"] = torch.from_numpy(
        np.asarray(t["params"]["nested"]["b"], np.float32)).to(torch.bfloat16)
    return out


def _bits(x) -> np.ndarray:
    """A leaf's bits as an integer numpy array (bf16 -> int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _dtype_name(x) -> str:
    return str(x.dtype).split(".")[-1]


def _same_trees(got, want):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert _dtype_name(a) == _dtype_name(b)
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_layout_and_manifest_are_the_reference(tmp_path):
    base = _numpy_tree(1)
    C.save(str(tmp_path / "port"), 12, _torch_tree(base))
    JC.save(str(tmp_path / "ref"), 12, _jax_tree(base))
    for pkg in ("port", "ref"):
        assert sorted(os.listdir(tmp_path / pkg)) == \
            ["step_000000012", "step_000000012.COMMITTED"]
    port, ref = tmp_path / "port" / "step_000000012", \
        tmp_path / "ref" / "step_000000012"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    mp = json.loads((port / "manifest.json").read_text())
    mr = json.loads((ref / "manifest.json").read_text())
    assert {k: mp[k] for k in ("step", "n_leaves", "leaves")} == \
        {k: mr[k] for k in ("step", "n_leaves", "leaves")}
    assert "bfloat16" in [leaf["dtype"] for leaf in mp["leaves"]]
    for i, leaf in enumerate(mr["leaves"]):
        name = f"leaf_{i:05d}.npy"
        a, b = (port / name).read_bytes(), (ref / name).read_bytes()
        if leaf["dtype"] == "bfloat16":
            assert np.load(port / name).dtype == np.dtype("V2")
            assert np.load(port / name).tobytes() == \
                np.load(ref / name).tobytes()
        else:
            assert a == b, name


def test_port_checkpoint_restored_by_reference(tmp_path):
    base = _numpy_tree(2)
    C.save(str(tmp_path), 5, _torch_tree(base))
    got = JC.restore(str(tmp_path), 5, _jax_tree(_numpy_tree(0)))
    want = _torch_tree(base)
    assert str(got["params"]["nested"]["b"].dtype) == "bfloat16"
    _same_trees(want, got)


def test_reference_checkpoint_restored_by_port(tmp_path):
    base = _numpy_tree(3)
    JC.save(str(tmp_path), 7, _jax_tree(base))
    template = jax.tree.map(lambda t: t.to("meta"),
                            _torch_tree(_numpy_tree(0)))
    got = C.restore(str(tmp_path), 7, template)
    _same_trees(got, _jax_tree(base))
    got, step = C.restore_latest(str(tmp_path), template, device="cpu")
    assert step == 7
    _same_trees(got, _jax_tree(base))


def test_save_restore_roundtrip_with_bf16(tmp_path):
    tree = _torch_tree(_numpy_tree(1))
    C.save(str(tmp_path), 7, tree)
    got = C.restore(str(tmp_path), 7, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_uncommitted_checkpoints_ignored(tmp_path):
    tree = _torch_tree(_numpy_tree(2))
    C.save(str(tmp_path), 3, tree)
    C.save(str(tmp_path), 9, tree)
    os.remove(str(tmp_path / "step_000000009.COMMITTED"))
    os.makedirs(tmp_path / "step_000000011.tmp")       # a crashed save
    got, step = C.restore_latest(str(tmp_path), tree)
    assert step == 3 and C.list_steps(str(tmp_path)) == [3]
    assert C.restore_latest(str(tmp_path / "none"), tree) == (None, -1)


def test_retention_gc(tmp_path):
    tree = _torch_tree(_numpy_tree(3))
    for s in range(6):
        C.save(str(tmp_path), s, tree, keep=2)
    assert C.list_steps(str(tmp_path)) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000004", "step_000000004.COMMITTED",
        "step_000000005", "step_000000005.COMMITTED"]


def test_async_checkpointer_saves_a_copy(tmp_path):
    """save_async takes its host copy before queueing: updating the
    trained tensors in place afterwards does not reach the checkpoint."""
    ck = C.AsyncCheckpointer(str(tmp_path), keep=3)
    trees = {s: _torch_tree(_numpy_tree(s)) for s in (1, 2, 3)}
    want = {s: jax.tree.map(lambda t: t.clone(), t)
            for s, t in trees.items()}
    for s, tree in trees.items():
        ck.save_async(s, tree)
        for leaf in tree_leaves(tree):          # the next step, in place
            leaf.add_(1)
    ck.close()
    assert C.list_steps(str(tmp_path)) == [1, 2, 3]
    for s in (1, 2, 3):
        got = C.restore(str(tmp_path), s, trees[s])
        for a, b in zip(tree_leaves(got), tree_leaves(want[s])):
            assert torch.equal(a, b), s
    assert int(got["params"]["nested"]["c"][0]) == 3


def test_async_failure_surfaces(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ck = C.AsyncCheckpointer(str(blocker), keep=1)  # a file, not a dir
    ck.save_async(1, {"a": torch.zeros(2)})
    ck.wait()
    with pytest.raises(RuntimeError, match="previous async save failed"):
        ck.save_async(2, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async save failed"):
        ck.close()
