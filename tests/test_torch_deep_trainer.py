"""One tau-averaging round of ResNet-50's BatchNorm blocks against the
JAX trainer, parameters and averaged BatchNorm stats included.

The net is the ResNet-50 builder's stem and its first two stages (conv1
through res3d: 24 convolutions, each with BatchNorm and Scale, and the
Eltwise shortcuts), then the global pool, fc and loss of the full net:
the full depth's float64 JAX trainer takes ~40 s a mode to compile here.
W=2 workers, tau=2, batch 2 at image 64, in float64 on both sides
(``jax.enable_x64``): in float32 BatchNorm over a few values a channel
amplifies rounding to several percent of an update in either package
(``test_torch_deep_models.py``), so float32 cannot referee the formula.
Compressions none and int8 (the int8 comm plane's 4 chunks leave one of
well over 32 leaves).  After the round every worker holds the same
stats, the workers' mean, equal to JAX's within 1e-9 of their scale;
the parameters within 1e-8 of each blob's move.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils.tree import tree_map

W, TAU, B, IMG = 2, 2, 2, 64
SOLVER = 'base_lr: 0.01 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0001'


def _stages_2_3(netp):
    """ResNet-50 through res3d, then its pool5, fc1000 and loss."""
    names = [lp.name for lp in netp.layer]
    keep = netp.layer[: names.index("relu_res3d") + 1]
    head = [netp.layer[names.index(n)] for n in ("pool5", "fc1000", "loss")]
    head[0].bottom = ["res3d"]
    netp.layer = keep + head
    return netp


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_resnet_round_matches_the_jax_trainer(compress):
    kw = dict(batch=B, image=IMG, classes=10)
    with jax.enable_x64(True):
        tsolver = TSolver(tconfig.parse_solver_prototxt(SOLVER), device="cpu",
                          net_param=_stages_2_3(tmodels.load_model("resnet50", **kw)))
        jsolver = JSolver(jconfig.parse_solver_prototxt(SOLVER),
                          net_param=_stages_2_3(jmodels.load_model("resnet50", **kw)))
        mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
        jt = JTrainer(jsolver, mesh, compress=compress)
        tt = TTrainer(tsolver, W, compress=compress)
        params, stats = tsolver.net.init(0)
        assert len(stats) == 24  # BatchNorm layers, three stat blobs each
        params, stats = (tree_map(lambda t: t.double(), x) for x in (params, stats))
        tstate = tt.broadcast_state(TrainState(
            params, stats, _init_history(tsolver.method, params), torch.tensor(0)))
        j0 = jsolver.init_state(0)
        jstate = jt.broadcast_state(j0._replace(
            params=tree_map(lambda t: jnp.asarray(t.numpy()), params),
            stats=tree_map(lambda t: jnp.asarray(t.numpy()), stats),
            history=jax.tree_util.tree_map(
                lambda h: jnp.zeros(h.shape, jnp.float64), j0.history)))
        rs = np.random.RandomState(0)
        data = {"data": rs.randn(W, TAU, B, 3, IMG, IMG),
                "label": rs.randint(0, 10, (W, TAU, B)).astype(np.float64)}
        jstate, jl = jt.round(jstate, shard_leading(data, mesh))
        tstate, tl = tt.round(tstate, {k: torch.from_numpy(v)
                                       for k, v in data.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10)
        for k, blobs in tstate.params.items():
            for i, t in enumerate(blobs):
                assert t.dtype == torch.float64
                want = np.asarray(jstate.params[k][i])
                step = float(np.abs(want - params[k][i].numpy()[None]).max())
                assert float(np.abs(t.numpy() - want).max()) <= 1e-8 * step, \
                    f"{k}[{i}]"
        for k, blobs in tstate.stats.items():
            for i, t in enumerate(blobs):
                want = np.asarray(jstate.stats[k][i])
                assert torch.equal(t[0], t[1]), f"{k}[{i}]: workers differ"
                scale = max(1e-300, float(np.abs(want).max()))
                assert float(np.abs(t.numpy() - want).max()) <= 1e-9 * scale
    if compress == "int8":
        leaves, chunks = tt._comm.plan(tstate)
        assert len(leaves) == 74 + 72 and max(s.stop - s.start for s in chunks) > 32
