"""The PyTorch port stands alone: no JAX, nothing of ``repro``, and no
quiet fallback to the CPU; it writes to stdout only through
``telemetry/console.py``."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|"
                       r"from\s+repro(\.|\s))", re.M)
PRINT = re.compile(r"\bprint\(")
CONSOLE = PKG / "telemetry" / "console.py"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    text = path.read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_print_only_in_the_console_module():
    """The counterpart of the reference's print lint: ``console_line``
    is the one ``print`` call site of the package."""
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in sorted(PKG.rglob("*.py"))
            if p != CONSOLE
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if PRINT.search(line)]
    assert not hits, hits
    assert len(PRINT.findall(CONSOLE.read_text())) == 2  # docstring + call


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "new = {'repro_torch.sim.churn',\n"
        "       'repro_torch.costmodel.descriptors',\n"
        "       'repro_torch.core.scheduler', 'repro_torch.core.generalist',\n"
        "       'repro_torch.core.generalist.env',\n"
        "       'repro_torch.core.generalist.features',\n"
        "       'repro_torch.core.generalist.rollout',\n"
        "       'repro_torch.core.generalist.train',\n"
        "       'repro_torch.telemetry.console',\n"
        "       'repro_torch.telemetry.metrics',\n"
        "       'repro_torch.telemetry.profiler',\n"
        "       'repro_torch.telemetry.runmeta',\n"
        "       'repro_torch.telemetry.schema',\n"
        "       'repro_torch.telemetry.sink',\n"
        "       'repro_torch.models.encdec', 'repro_torch.models.moe',\n"
        "       'repro_torch.optim.optimizers',\n"
        "       'repro_torch.optim.schedules', 'repro_torch.data.pipeline',\n"
        "       'repro_torch.runtime.fault', 'repro_torch.runtime.compression',\n"
        "       'repro_torch.launch.train', 'repro_torch.tree',\n"
        "       'repro_torch.runtime.straggler',\n"
        "       'repro_torch.models.sharding', 'repro_torch.models.partition',\n"
        "       'repro_torch.launch.mesh', 'repro_torch.runtime.elastic',\n"
        "       'repro_torch.kernels.head_shards',\n"
        "       'repro_torch.kernels._library',\n"
        "       'repro_torch.launch.dryrun', 'repro_torch.launch.roofline',\n"
        "       'repro_torch.launch.hlo_analysis'}\n"
        "assert new <= set(names), new - set(names)\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_default_device_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import Actor, PolicyConfig
    from repro_torch.core import ddpg
    from repro_torch.launch import rl_train, serve, train
    from repro_torch.models import LM
    from repro_torch.serving import ContinuousBatcher, MultiTenantService
    from repro_torch.sim.env import EnvConfig, SchedulingEnv
    from repro_torch.workloads import build_registry
    reg = build_registry("light")
    cfg = get_arch("internlm2-1.8b", smoke=True)
    for fn in (lambda: MultiTenantService(reg),
               lambda: SchedulingEnv(reg, EnvConfig()),
               lambda: Actor(PolicyConfig(feat_dim=16, act_dim=7)),
               lambda: serve.main(["--workload", "light", "--batched"]),
               lambda: serve.main(["--workload", "lm_light", "--batched"]),
               lambda: LM(cfg),
               lambda: LM(get_arch("mamba2-2.7b", smoke=True)),
               lambda: LM(get_arch("whisper-tiny", smoke=True)),
               lambda: LM(get_arch("olmoe-1b-7b", smoke=True)),
               lambda: ContinuousBatcher(LM(cfg)),
               lambda: rl_train.main(["--workload", "light"]),
               lambda: train.main(["--arch", "internlm2-1.8b", "--smoke",
                                   "--steps", "1"]),
               lambda: ddpg.init_ddpg(torch.Generator(), ddpg.DDPGConfig(
                   PolicyConfig(feat_dim=16, act_dim=7)))):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
