"""Loading every module of the harness brings in no module whose whole
top-level name is jax, jaxlib, flax or the JAX package (``repro``);
``repro_torch``, the port, is another name. Nothing reads ``benchmarks/``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ROOT / "h100bench"


def sources():
    return [p for p in sorted(HARNESS.rglob("*.py"))
            if "tests" not in p.relative_to(HARNESS).parts]


def modules():
    return [".".join(p.relative_to(ROOT).with_suffix("").parts)
            .replace(".__init__", "") for p in sources()]


def test_no_jax_or_reference_package_loaded():
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {modules()!r}: importlib.import_module(m)\n"
        "import repro_torch.core.backend, repro_torch.models\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "h100bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_harness_does_not_read_the_jax_benchmarks():
    for p in sources():
        text = p.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text
        assert "from benchmarks" not in text
