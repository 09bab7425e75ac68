"""The port's sequence ring, blockwise attention and ``Attention`` layer
against the JAX package's, on the CPU.

- ``_merge_partials``: values and gradients, ``-inf`` legs included
  (one side empty, both sides empty), against JAX's.
- The stacked ring (``ring_self_attention`` over a mesh axis that stays
  in this process) at sp = 2 and 4, causal and not, each step's partial
  through ``flash_attention_step`` (its plain version on CPU tensors)
  and through the dense recurrence: forward and q/k/v gradients within
  1e-5 of JAX ``ring_self_attention(use_flash=False)`` on the 8-device
  CPU mesh.
- The process ring over gloo at 2 and 4 ranks with one shard a rank,
  and at 2 ranks with two mesh slots (two shards) a rank (KV rotated
  with ``batch_isend_irecv`` a block at a time, the cotangent rotated
  back): the ranks' output blocks and summed gradients against the same
  JAX ring.
- The ragged-T refusal, with the JAX message.
- ``blockwise_attention`` and the ``Attention`` layer against JAX's,
  the layer's weights carried across in Caffe blob order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu.net import JaxNet
from sparknet_tpu.ops.attention import blockwise_attention as j_blockwise
from sparknet_tpu.parallel import make_mesh as j_make_mesh
from sparknet_tpu.parallel.ring_attention import _merge_partials as j_merge
from sparknet_tpu.parallel.ring_attention import ring_self_attention as j_ring
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch.interop import net_params_from_jax
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.ops.attention import blockwise_attention, mha_reference
from sparknet_tpu_torch.parallel import mesh as tmesh
from sparknet_tpu_torch.parallel.ring_attention import (
    _merge_partials,
    masked_pairs,
    ring_attention,
    ring_self_attention,
)
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
B, T, H, D = 2, 16, 2, 8


def _qkvd(seed=0, t=T):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, t, H, D).astype(np.float32) for _ in range(4)]


def _jax_ring(n, causal, q, k, v, do):
    """JAX's dense ring over n of the 8 CPU devices: (out, dq, dk, dv)."""
    mesh = j_make_mesh({"sp": n}, devices=jax.devices()[:n])
    fn = j_ring(mesh, "sp", causal=causal, use_flash=False)
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(do)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


# ----------------------------------------------------------------------
# the merge
@pytest.mark.parametrize("legs", ["finite", "one_empty", "both_empty"])
def test_merge_partials_matches_jax(legs):
    rng = np.random.RandomState(3)
    o1, o2 = (rng.randn(2, 2, 5, 4).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.randn(2, 2, 5).astype(np.float32) for _ in range(2))
    if legs != "finite":
        l1[:, :, ::2] = -np.inf  # rows whose first side saw no keys
        o1[:, :, ::2] = 0.0
    if legs == "both_empty":
        l2[:, :, ::2] = -np.inf
        o2[:, :, ::2] = 0.0
    do = rng.randn(2, 2, 5, 4).astype(np.float32)
    dl = rng.randn(2, 2, 5).astype(np.float32)

    def jf(a, b, c, d):
        o, l = j_merge(a, b, c, d)
        return jnp.sum(o * do) + jnp.sum(jnp.where(jnp.isfinite(l), l, 0) * dl)

    jo, jl = j_merge(o1, l1, o2, l2)
    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(o1, l1, o2, l2)
    ts = [torch.tensor(a, requires_grad=True) for a in (o1, l1, o2, l2)]
    to, tl = _merge_partials(*ts)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_array_equal(np.isinf(tl.detach().numpy()),
                                  np.isinf(np.asarray(jl)))
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(tl.detach().numpy()[fin], np.asarray(jl)[fin],
                               atol=1e-6)
    loss = (to * torch.from_numpy(do)).sum() + (torch.where(
        torch.isfinite(tl), tl, torch.zeros_like(tl)) * torch.from_numpy(dl)).sum()
    loss.backward()
    for t, g in zip(ts, jg):
        # JAX's lse cotangent reads NaN on the rows where both legs are
        # empty (the maximum's tie at -inf); the port's guard keeps every
        # cotangent finite and agrees wherever JAX's is
        g = np.asarray(g)
        assert torch.isfinite(t.grad).all()
        fin = np.isfinite(g)
        assert fin.all() or legs == "both_empty"
        np.testing.assert_allclose(t.grad.numpy()[fin], g[fin], atol=1e-6)


def test_masked_pairs_of_a_causal_ring():
    assert masked_pairs(4, causal=True) == [
        (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    assert masked_pairs(4, causal=False) == []


# ----------------------------------------------------------------------
# the stacked ring
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_stacked_ring_matches_jax_ring(n, causal, use_flash):
    q, k, v, do = _qkvd(n)
    want = _jax_ring(n, causal, q, k, v, do)
    mesh = tmesh.make_mesh({"sp": n}, workers_per_process=n)
    assert mesh.group("sp") is None  # the axis stays in this process
    fn = ring_self_attention(mesh, "sp", causal=causal, use_flash=use_flash)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), want[0], "out")
    for name, t, g in zip("qkv", ts, want[1:]):
        _close(t.grad.numpy(), g, f"d{name}")
    # and the sp=1 dense attention it distributes
    _close(out.detach().numpy(),
           mha_reference(*[torch.from_numpy(a) for a in (q, k, v)],
                         causal=causal).numpy(), "vs mha_reference")


def test_ring_refuses_ragged_t():
    mesh = tmesh.make_mesh({"sp": 4}, workers_per_process=4)
    fn = ring_self_attention(mesh, "sp", causal=True)
    q = torch.zeros(B, 18, H, D)
    with pytest.raises(ValueError, match="does not divide over the 4-way "
                       "'sp' ring — pad the sequence or pick T a multiple"):
        fn(q, q, q)
    with pytest.raises(ValueError, match=r"must be \(B, T, H, D\)"):
        fn(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="equal shards"):
        ring_attention(q, q, q, 4)


# ----------------------------------------------------------------------
# the process ring over gloo: `slots` consecutive shards a rank
_RING_WORKER = r"""
import sys

import numpy as np
import torch

pid, address, n, slots, src, out = (int(sys.argv[1]), sys.argv[2],
                                    int(sys.argv[3]), int(sys.argv[4]),
                                    sys.argv[5], sys.argv[6])
from sparknet_tpu_torch.parallel import mesh
from sparknet_tpu_torch.parallel.ring_attention import ring_self_attention

mesh.initialize_distributed(address, n, pid, device="cpu")
m = mesh.make_mesh({"sp": n * slots}, workers_per_process=slots)
assert m.group("sp") is not None
assert m.coords["sp"] == slice(pid * slots, (pid + 1) * slots)
z = np.load(src)
res = {}
for causal in (False, True):
    for flash in (True, False):
        ts = [torch.tensor(z[k], requires_grad=True) for k in "qkv"]
        fn = ring_self_attention(m, "sp", causal=causal, use_flash=flash)
        o = fn(*ts)
        tq = o.shape[1]
        o.backward(torch.from_numpy(z["do"][:, pid * tq:(pid + 1) * tq]))
        tag = f"{int(causal)}{int(flash)}"
        res["o" + tag] = o.detach().numpy()
        for k, t in zip("qkv", ts):
            res["d" + k + tag] = t.grad.numpy()
np.savez(out, **res)
if n == 2:
    # sp=3 over 2 processes of 3 slots: blocks 0..1 and 1..2 overlap
    ragged = mesh.make_mesh({"sp": 3, "dp": 2}, workers_per_process=3)
    try:
        ring_self_attention(ragged, "sp")
        raise SystemExit("an overlapping layout of the ring was taken")
    except ValueError as e:
        assert "equal consecutive blocks" in str(e), e
mesh.shutdown()
print(f"RING_OK p{pid}")
"""


@pytest.mark.parametrize("n, slots", [(2, 1), (4, 1), (2, 2)],
                         ids=["2", "4", "2x2"])
def test_process_ring_matches_jax_ring(tmp_path, n, slots):
    q, k, v, do = _qkvd(10 + n * slots)
    src = str(tmp_path / "qkv.npz")
    np.savez(src, q=q, k=k, v=v, do=do)
    outs = [str(tmp_path / f"r{i}.npz") for i in range(n)]
    procs.run_worker_processes(
        _RING_WORKER, "RING_OK", REPO, nprocs=n, args=[str(n), str(slots), src],
        per_rank_args=[[o] for o in outs], timeout=300, workdir=str(tmp_path))
    got = [np.load(o) for o in outs]
    for causal in (False, True):
        want = _jax_ring(n * slots, causal, q, k, v, do)
        for flash in (1, 0):
            tag = f"{int(causal)}{flash}"
            _close(np.concatenate([g["o" + tag] for g in got], axis=1),
                   want[0], f"out {tag}")
            for name, w in zip("qkv", want[1:]):
                # each rank's grads reach only its shard's rows
                _close(sum(g["d" + name + tag] for g in got), w,
                       f"d{name} {tag}")


# ----------------------------------------------------------------------
# blockwise attention and the layer
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [4, 5, 16])
def test_blockwise_attention_matches_jax(causal, block):
    q, k, v, _ = _qkvd(7)
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(j_blockwise(q, k, v, block, causal=causal))
    got = blockwise_attention(*[torch.from_numpy(np.array(a)) for a in (q, k, v)],
                              block, causal=causal)
    _close(got.numpy(), want, "blockwise")
    # and a shorter query block, end-aligned like mha_reference
    want = np.asarray(j_blockwise(q[:, 5:], k, v, block, causal=causal))
    got = blockwise_attention(torch.from_numpy(np.array(q[:, 5:])),
                              torch.from_numpy(np.array(k)),
                              torch.from_numpy(np.array(v)), block,
                              causal=causal)
    _close(got.numpy(), want, "blockwise, T_q < T_k")


ATTN_NET = """
layer { name: "d" type: "HostData" top: "x"
  java_data_param { shape { dim: 2 dim: 12 dim: 16 } } }
layer { name: "attn" type: "Attention" bottom: "x" top: "y"
  attention_param { num_heads: 2 causal: %s block_size: 5 } }
layer { name: "red" type: "Reduction" bottom: "y" top: "loss"
  loss_weight: 1.0 reduction_param { operation: SUMSQ axis: 0 } }
"""


@pytest.mark.parametrize("causal", ["true", "false"])
def test_attention_layer_matches_jax(causal):
    text = ATTN_NET % causal
    jnet = JaxNet(jconfig.parse_net_prototxt(text), phase="TRAIN")
    jp, js = jnet.init(0)
    tnet = TorchNet(tconfig.parse_net_prototxt(text), phase="TRAIN")
    tp, ts = net_params_from_jax(jax.device_get(jp), tnet)
    assert [tuple(b.shape) for b in tp["attn"]] == [(16, 48), (48,), (16, 16),
                                                    (16,)]
    x = np.random.RandomState(5).randn(2, 12, 16).astype(np.float32)
    jy = np.asarray(jnet.forward(jp, js, {"x": x})["y"])
    ty = tnet.forward(tp, ts, {"x": torch.from_numpy(x)})["y"]
    _close(ty.numpy(), jy, "layer forward")
    jg = jax.grad(lambda p: jnet.loss_fn(p, js, {"x": x})[0])(jp)
    leaves = [b.requires_grad_() for b in tp["attn"]]
    loss = tnet.loss_fn(tp, ts, {"x": torch.from_numpy(x)})[0]
    loss.backward()
    for i, t in enumerate(leaves):
        g = np.asarray(jg["attn"][i])
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(),
                                   err_msg=f"grad {i}")
