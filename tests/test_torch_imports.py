"""The port is self-contained: importing every module of
``gr_ieee80211_tpu_torch``, ``tools_torch`` and ``chip_smoke`` loads
neither ``jax`` nor anything of the JAX package ``gr_ieee80211_tpu``, and
no source line of theirs names such an import."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = "gr_ieee80211_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gr_ieee80211_tpu")


def _port_modules():
    names = [PORT]
    for pkg in (PORT, "tools_torch"):
        names += sorted(m.name for m in pkgutil.walk_packages(
            [str(ROOT / pkg)], prefix=pkg + "."))
    return names + ["tools_torch", "chip_smoke"]


def _sources():
    files = sorted((ROOT / PORT).rglob("*.py"))
    files += sorted((ROOT / "tools_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    """``gr_ieee80211_tpu`` and ``gr_ieee80211_tpu.x`` are forbidden;
    ``gr_ieee80211_tpu_torch`` (same first letters) is the port itself."""
    return module.split(".")[0] in FORBIDDEN


def test_port_has_the_expected_modules():
    mods = _port_modules()
    for want in ("models.rx", "models.tx", "gold.rx", "gold.sounding",
                 "ops.viterbi_kernels", "ops.fastdecode",
                 "spec.params", "spec.tables", "gold.bits", "gold.sig",
                 "gold.mac", "gold.tx", "gold.channel", "runtime.native",
                 "runtime.udp_phy", "runtime.streaming", "utils.io",
                 "parallel.mesh", "parallel.distributed", "entry"):
        assert f"{PORT}.{want}" in mods
    for tool in ("trace_check", "rx_daemon", "tx_daemon", "cmu_demo",
                 "mac_example_rx", "mac_example_tx", "pkt_gen_example",
                 "pkt_gen_ow_example", "pkt_proc_example", "cmu_offline",
                 "draw_bin", "mesh_worker", "timing", "bench",
                 "bench_snr_sweep", "bench_long", "perf_sweep", "bench_tx",
                 "bench_mu", "bench_daemon", "latency_report",
                 "multihost_scaling", "stage_times", "chain_time"):
        assert f"tools_torch.{tool}" in mods
    assert not _forbidden(PORT) and _forbidden("gr_ieee80211_tpu.spec")
    assert _forbidden("jax.numpy") and _forbidden("gr_ieee80211_tpu")


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter (without the JAX that pytest's own process holds) imports every
    module; ``sys.modules`` then holds nothing forbidden."""
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"assert '{PORT}.models.rx' in sys.modules\n"
        "print('imported', len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == f"imported {len(_port_modules())}"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    """AST scan: no ``import``/``from`` of a forbidden module, relative
    imports never leave the package, and no ``importlib``/``__import__``
    call names one."""
    tree = ast.parse(path.read_text())
    depth = len(path.relative_to(ROOT).parts) - 1   # packages above the file
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert not _forbidden(a.name), (path, node.lineno, a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.level <= depth, (path, node.lineno)
            else:
                assert not _forbidden(node.module), (path, node.lineno,
                                                     node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__"):
                for a in node.args[:1]:
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str):
                        assert not _forbidden(a.value), (path, node.lineno)


@pytest.mark.parametrize("path", sorted((ROOT / PORT / "utils").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_utils_import_no_higher_layer(path):
    """The lowest layer imports nothing of the port's ``ops`` or
    ``models``: the layers above count into it, it reads none of them."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            names = [mod] + [f"{mod}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            parts = name.lstrip(".").split(".")
            assert not {"ops", "models"} & set(parts[:2]), (path,
                                                            node.lineno, name)
