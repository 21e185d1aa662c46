"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the same on-disk format, so a step saved by either package
loads bit for bit in the other, bf16 leaves included (stored as their
uint16 bits); retention, the meta peek, atomic writes, and an async save
that is not torn by a later in-place update."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.optim import AdamWState as JaxAdamWState
from repro_torch import bridge
from repro_torch import checkpoint as tck
from repro_torch.optim import AdamWState

from torch_parity import TINY1


def _jax_state(seed=0):
    """A TINY1-shaped params tree (f32 with bf16 leaves) and an AdamW state
    with random moments, made from a numpy seed."""
    from repro.models.model import init_params
    from torch_parity import jax_cfg
    params = init_params(jax_cfg(TINY1), jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(params)
    # every other leaf in bf16: both dtypes in one tree
    leaves = [jnp.asarray(x, jnp.bfloat16) if i % 2 else x
              for i, x in enumerate(leaves)]
    params = jax.tree.unflatten(treedef, leaves)

    def moment(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    opt = JaxAdamWState(m=jax.tree.map(moment, params),
                        v=jax.tree.map(lambda x: moment(x) ** 2, params),
                        count=jnp.asarray(7, jnp.int32))
    return {"params": params, "opt": opt}


def _torch_state(jstate):
    opt = jstate["opt"]
    return {"params": bridge.to_torch(jax.tree.map(np.asarray,
                                                   jstate["params"])),
            "opt": AdamWState(m=bridge.to_torch(jax.tree.map(np.asarray,
                                                             opt.m)),
                              v=bridge.to_torch(jax.tree.map(np.asarray,
                                                             opt.v)),
                              count=int(opt.count))}


def _bits(a):
    """The raw bits of an array or tensor, as a numpy array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _npz_keys(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}",
                              "arrays.0.npz")) as z:
        return list(z.files)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_bitwise_across_packages(tmp_path, writer):
    """A step saved by one package loads in the other with the same key
    set and order, the same dtypes and the same bits; the port's manager
    restores it into an AdamWState whose count is an int."""
    jstate = _jax_state()
    tstate = _torch_state(jstate)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save_step(dj, 3, jstate, {"who": "jax"})
    tck.save_step(dt, 3, tstate, {"who": "torch"})
    assert _npz_keys(dj, 3) == _npz_keys(dt, 3)
    src = dj if writer == "jax" else dt
    want, _ = jck.load_step(dj, 3)           # the JAX package's own reading
    if writer == "jax":
        got, meta = tck.load_step(src, 3)
        assert meta["who"] == "jax"
    else:
        got, meta = jck.load_step(src, 3)
        assert meta["who"] == "torch"
    assert list(got) == list(want)
    assert "opt|count" in got and "opt|m|embed|tok" in got
    for k in want:
        g, w = got[k], want[k]
        gd = str(g.dtype).replace("torch.", "")
        assert gd == str(np.asarray(w).dtype), k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
    assert meta["_dtypes"] == jck.load_meta(dj, 3)["_dtypes"]
    assert set(meta["_dtypes"].values()) == {"bfloat16"}

    tmpl = {"params": tstate["params"],
            "opt": AdamWState(tstate["opt"].m, tstate["opt"].v, 0)}
    state, _ = tck.CheckpointManager(src).restore(3, tmpl)
    assert isinstance(state["opt"], AdamWState) and state["opt"].count == 7
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(state["params"])),
                    jax.tree.leaves(bridge.to_numpy(tstate["params"]))):
        np.testing.assert_array_equal(a, b)


def test_manager_keep_latest_meta_and_atomic_writes(tmp_path):
    d = str(tmp_path / "ck")
    mgr = tck.CheckpointManager(d, keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, {"note": s})
    mgr.wait()
    assert tck.list_steps(d) == [3, 4]
    assert mgr.latest_step() == 4
    assert mgr.latest_meta()["note"] == 4 and mgr.latest_meta()["step"] == 4
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_ckpt_")]
    got, meta = mgr.restore_latest({"w": torch.zeros(2, 3)})
    assert torch.equal(got["w"], tree["w"]) and meta["step"] == 4
    with pytest.raises(ValueError, match="expected"):
        mgr.restore(4, {"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(4, {"u": torch.zeros(2, 3)})
    assert tck.CheckpointManager(str(tmp_path / "none")).latest_meta() is None


@pytest.mark.parametrize("snapshot", ["host", "device"])
def test_async_save_is_not_torn_by_a_later_in_place_update(tmp_path,
                                                           snapshot):
    """``save`` pins the tree before it returns: a tensor changed in place
    right after is written as it was at the call."""
    d = str(tmp_path / "ck")
    mgr = tck.CheckpointManager(d)
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(4, dtype=torch.bfloat16)
    want_w, want_b = w.clone(), b.clone()
    mgr.save(1, {"w": w, "b": b}, snapshot=snapshot)
    w.add_(1.0)
    b.mul_(3.0)
    mgr.wait()
    got, _ = tck.load_step(d, 1)
    assert torch.equal(got["w"], want_w)
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], want_b)
