"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads the program neither. Each check runs in a subprocess whose
import system refuses those modules by whole top-level name (the port's
``karpenter_tpu_torch`` begins with ``karpenter_tpu``)."""

import os
import subprocess
import sys
import textwrap

import bench_support  # noqa: F401 (the repository root on the path)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GUARD = textwrap.dedent("""
    import sys
    REFUSED = set(sys.argv[1].split(","))

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[2])
""")


def _run(refused, body):
    code = GUARD + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code, ",".join(refused),
                           ROOT], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    r = _run(("jax", "jaxlib", "flax", "karpenter_tpu"), """
        import json, time
        sys.path.insert(0, sys.argv[2] + "/benchmark/tests")
        from bench_support import small_cell
        from benchmark import harness
        for w in ("solve-burst-cold", "consolidate-multi-5k"):
            out = harness.run(w, 5, 0.5, False, time.perf_counter(),
                              device="cpu", cell=small_cell(w))
            assert out["correct"], out
        loaded = {m.split(".")[0] for m in sys.modules}
        assert "karpenter_tpu_torch" in loaded
        assert not loaded & {"jax", "jaxlib", "flax", "karpenter_tpu"}
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_the_reference_loads_no_part_of_the_program():
    r = _run(("jax", "jaxlib", "flax", "karpenter_tpu",
              "karpenter_tpu_torch"), """
        import benchmark.reference.solve_check
        import benchmark.reference.consolidate_check
        import benchmark.reference.topology
        import benchmark.spec, benchmark.spans, benchmark.roofline
        import benchmark.devtrace
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]


def test_the_guard_tells_the_port_from_the_jax_package():
    r = _run(("karpenter_tpu",), """
        import karpenter_tpu_torch.ops.binpack
        try:
            import karpenter_tpu
        except ImportError:
            print("refused")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "refused"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "karpenter_tpu_torch_x", sys)
    assert "karpenter_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "karpenter_tpu.api", sys)
    assert "karpenter_tpu" in harness.forbidden_modules()


def test_run_refuses_without_cuda_and_prints_no_result(tmp_path):
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "solve-burst-cold", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "consolidate-multi-5k", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
