"""Elastic restore across meshes and across the two packages: the
port's ``runtime.elastic`` on gloo ranks on the CPU and the JAX
package's ``runtime.elastic`` on 8 XLA CPU devices (a subprocess with
the device-count flag set before ``import jax``, as
tests/test_dryrun_subproc.py does), internlm2-smoke:

- the port saves its state ({"params", "opt"} after 2 train steps) placed
  on (2, 2) and ``reshard_restore`` places it on (4, 1) and on (1, 4);
- a checkpoint JAX's ``device_put_like`` placed on a (2, 4) mesh and
  saved restores into the port's (2, 2);
- the port's checkpoint restores through JAX's ``reshard_restore`` onto
  (4, 2).

Every leaf bit-equal in all three: a rank's block against the block its
placements cut from the values saved, JAX's arrays against the file.
"""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import rl_train
from repro_torch.launch import train as TRN

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu"}
RANK_TIMEOUT_S = 120
HEAD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs.registry import get_arch
from repro.models.model import build_model
from repro.models import sharding as shd
from repro.launch.mesh import make_mesh
cfg = get_arch("internlm2-1.8b", smoke=True)
model = build_model(cfg)
"""
JAX_SAVE = HEAD + r"""
from repro.ckpt import save_checkpoint
from repro.runtime.elastic import device_put_like
params = model.init(jax.random.PRNGKey(3))
pa = device_put_like(params, make_mesh((2, 4), ("data", "model")),
                     shd.make_rules(False))
assert max(len(x.sharding.device_set) for x in jax.tree.leaves(pa)) == 8
save_checkpoint("%DIR%", 0, {"params": pa})
print("JAX_SAVED")
"""
JAX_RESTORE = HEAD + r"""
from jax.sharding import PartitionSpec as P
from repro.ckpt import restore_checkpoint
from repro.optim import make_optimizer
from repro.runtime.elastic import reshard_restore
shape = jax.eval_shape(model.init, jax.random.PRNGKey(0))
like = {"params": shape,
        "opt": jax.eval_shape(make_optimizer("adamw").init, shape)}
pb, step, _ = reshard_restore("%DIR%", like,
                              make_mesh((4, 2), ("data", "model")))
host, _, _ = restore_checkpoint("%DIR%", like)
n = 0
for a, b in zip(jax.tree.leaves(pb), jax.tree.leaves(host)):
    np.testing.assert_array_equal(np.asarray(a), b)
    n += 1
wq = pb["params"]["stack"]["mixer"]["wq"].sharding
assert wq.spec == P(None, "data", "model", None), wq.spec
assert wq.mesh.shape == {"data": 4, "model": 2}
print("JAX_RESTORED", n)
"""


def _jax(script: str, directory: str) -> str:
    r = subprocess.run([sys.executable, "-c",
                        script.replace("%DIR%", directory)], env=ENV,
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    return r.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX saves from (2, 4); then one spawn of 4 ranks: the port's state
    on (2, 2) saved and restored onto (4, 1) and (1, 4), and JAX's
    checkpoint restored onto (2, 2); then JAX restores the port's."""
    tmp = tmp_path_factory.mktemp("elastic")
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    assert "JAX_SAVED" in _jax(JAX_SAVE, jax_dir)
    base = dict(arch="internlm2-1.8b", smoke=True, seed=0, device="cpu",
                mesh=(2, 2))
    jobs = [dict(base, train=dict(steps=2, batch=4, seq=16, total_steps=100),
                 elastic=dict(dir=port_dir, meshes=[(4, 1), (1, 4)])),
            dict(base, restore=jax_dir)]
    ranks = rl_train.spawn_ranks(TRN.mesh_steps_rank, 4, jobs, device="cpu",
                                 timeout=RANK_TIMEOUT_S)
    return ranks, _jax(JAX_RESTORE, port_dir)


def test_port_state_restores_across_meshes(runs):
    ranks, _ = runs
    for r, rk in enumerate(ranks):
        assert rk[0]["loaded"] == []
        recs = rk[0]["elastic"]
        assert [rec["mesh"] for rec in recs] == [(4, 1), (1, 4)]
        for rec in recs:
            # 12 parameters, and AdamW's m and v of each
            assert rec["equal"] and rec["leaves"] == 36, (r, rec["mesh"])
        assert rk[0]["train"][1]["loss"] < rk[0]["train"][0]["loss"]
    # the restored blocks are the new meshes' blocks
    wq = {rec["mesh"]: rec["placements"]["params/stack/mixer/wq"]
          for rec in ranks[0][0]["elastic"]}
    assert wq[(4, 1)]["local"] == (2, 16, 4, 16)
    assert wq[(1, 4)]["local"] == (2, 64, 1, 16)


def test_jax_checkpoint_restores_into_the_port_mesh(runs):
    ranks, _ = runs
    for r, rk in enumerate(ranks):
        rec = rk[1]["restore"]
        assert rec["equal"] and rec["leaves"] == 12, r
        assert rec["mesh"] == (2, 2)
    assert ranks[0][1]["restore"]["placements"]["params/embed"]["local"] \
        == (256, 32)


def test_port_checkpoint_restores_through_jax(runs):
    _, out = runs
    assert "JAX_RESTORED 36" in out
