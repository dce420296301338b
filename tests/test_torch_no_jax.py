"""The port must run where JAX is absent: no module of vlrlhf_torch (nor
chip_smoke.py) imports jax or vlrlhf_tpu, every module imports with jax
blocked, and chip_smoke.py refuses to run without a CUDA device."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vlrlhf_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|vlrlhf_tpu)\b", re.M)


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(p) for p in files if FORBIDDEN.search(p.read_text())]
    assert not offenders, offenders


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vlrlhf_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'vlrlhf_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.argv))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_fails_without_cuda(tmp_path):
    """On a machine without a card the script exits non-zero and prints no
    result line; alone in a directory (no port beside it) it fails too."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_every_module_imports_without_pandas_or_pil():
    """The card machine has neither pandas nor PIL: every module of the
    port (the eval harness, speculative decoding and multi-adapter
    serving among them) imports with both blocked, and none is pulled in."""
    mods = list(_modules())
    for new in ("vlrlhf_torch.eval.harness", "vlrlhf_torch.eval.benchmarks",
                "vlrlhf_torch.eval.datasets", "vlrlhf_torch.eval.db", "vlrlhf_torch.eval.judge",
                "vlrlhf_torch.eval.scorers", "vlrlhf_torch.eval.xlsx",
                "vlrlhf_torch.generate.speculative"):
        assert new in mods, new
    code = (
        "import sys\n"
        "for name in ('jax', 'vlrlhf_tpu', 'pandas', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'vlrlhf_tpu', 'pandas', 'PIL')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
