"""The import guard and the refusals: forbidden modules are found by their
top-level name compared whole (the port's name begins with the JAX
package's); the harness imports neither JAX, the JAX package nor the repo's
scripts, and imports the port only where it runs it; ``run.py`` prints no
result without a card, without the port beside it, or with JAX loaded."""
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys

from conftest import PB, ROOT

spec = importlib.util.spec_from_file_location("portbench_run", os.path.join(PB, "run.py"))
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("lagomorph_tpu_torch", "lagomorph_tpu_torch.lddmm", "jax_like", "benchmark",
                 "profile", "profile_atlasx"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    before = run.forbidden_modules()
    for name in ("lagomorph_tpu.ops", "jaxlib", "flax.linen", "bench", "chip_smoke",
                 "profile_atlas"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    after = run.forbidden_modules()
    assert set(after) - set(before) == {"lagomorph_tpu", "jaxlib", "flax", "bench", "chip_smoke",
                                        "profile_atlas"}


def _py(code, cwd=ROOT, env=None, args=()):
    env = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, *(["-c", code] if code else []), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_harness_imports_no_jax_and_not_the_port():
    files = [os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(PB, "**", "*.py"),
                                                         recursive=True)
             if "/tests/" not in p]
    code = (
        "import importlib, sys\n"
        "from portbench import manifest\n"
        f"for f in {files!r}:\n"
        "    kind, stem = f.split('/')[-2], f.split('/')[-1][:-3]\n"
        "    if kind == 'metrics':\n"
        "        manifest.reader(stem)\n"
        "    elif kind == 'work' and not stem.startswith('_'):\n"
        "        manifest.work(stem)\n"
        "    else:\n"
        "        importlib.import_module(f[:-3].replace('/', '.').replace('.__init__', ''))\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
        "'lagomorph_tpu', 'lagomorph_tpu_torch', 'bench', 'chip_smoke', 'profile_atlas'})\n"
        "assert not bad, bad\nprint('clean', len(sys.argv))\n")
    r = _py(code)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_no_card_no_result():
    r = _py(None, env={"CUDA_VISIBLE_DEVICES": ""},
            args=["portbench/run.py", "--workload", "lddmm3d_128.resident", "--seed",
                  str(2**40), "--seconds", "1", "--trace", "0"])
    assert r.returncode == 2 and r.stdout == "", (r.stdout, r.stderr)
    assert "CUDA card" in r.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for device in ("cuda", "cpu"):
        r = _py(None, cwd=tmp_path, args=["portbench/run.py", "--workload",
                                          "lddmm2d_512.resident", "--seed", "1", "--seconds",
                                          "1", "--trace", "0", "--device", device])
        assert r.returncode != 0 and r.stdout == "", (r.stdout, r.stderr[-2000:])


def test_jax_loaded_no_result(checkout):
    code = ("import sys, runpy; sys.modules['jax'] = type(sys)('jax'); "
            "sys.argv = ['run.py', '--workload', 'tiny3d.one', '--seed', '3', '--seconds', "
            "'0.2', '--trace', '0', '--device', 'cpu']; "
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    r = _py(code, cwd=checkout)
    assert r.returncode == 3 and r.stdout == "", (r.stdout, r.stderr[-2000:])
    assert "jax" in r.stderr


def test_cpu_run_prints_one_result(checkout):
    r = _py(None, cwd=checkout, args=["portbench/run.py", "--workload", "tiny3d.one", "--seed",
                                      str(2**31 + 99), "--seconds", "0.5", "--trace", "1",
                                      "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["fallbacks"]["value"] == 0.0
    assert {"busy_s", "window_s"} <= set(res["device"])
