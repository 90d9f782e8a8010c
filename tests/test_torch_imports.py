"""``repro_torch`` and ``chip_smoke.py`` import neither jax nor ``repro``.

A subprocess blocks both packages (``sys.modules[name] = None`` makes any
import of them raise) and then imports every module of the port and the
smoke script.  The card's machine has no jax; this keeps it that way.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pathlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_port_and_smoke_script_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_smoke_script_alone_fails_without_the_package(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_the_sharding_modules_are_among_those_imported():
    """The mesh slice's modules are in the package the probe walks."""
    import pkgutil
    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.shard", "repro_torch.shard.api",
            "repro_torch.shard.local", "repro_torch.launch.mesh",
            "repro_torch.distributed.compression"} <= names
