"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports jax, anything of the JAX package ``repro`` or ``ml_dtypes`` (the
card machine has none of them), and importing the port's modules builds
and loads no kernel."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_scan_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    for mod in (("launch", "serve.py"), ("launch", "train.py"),
                ("core", "grow.py"), ("training", "trainer.py"),
                ("optim", "adamw.py"), ("kernels", "ligo_expand_bwd.py"),
                ("kernels", "flash_attention.py"),
                ("checkpoint", "io.py"), ("checkpoint", "manager.py"),
                ("obs", "ledger.py"), ("obs", "costs.py"),
                ("obs", "_state.py"), ("obs", "trace.py"),
                ("obs", "export.py"), ("obs", "prom.py"),
                ("obs", "timeline.py"), ("launch", "_obs.py"),
                ("trajectory", "runner.py"), ("distributed", "supervisor.py"),
                ("examples", "quickstart.py"), ("examples", "serve_decode.py"),
                ("core", "grow_cache.py"),
                ("serving", "admission.py"), ("serving", "kv_pages.py"),
                ("serving", "speculative.py"), ("serving", "engine.py"),
                ("serving", "hotswap.py"), ("serving", "__init__.py"),
                ("autogrow", "__init__.py"), ("autogrow", "telemetry.py"),
                ("autogrow", "policy.py")):
        assert os.path.join("src", "repro_torch", *mod) in names
    assert len(names) >= 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path, mod)
        assert not mod.startswith("."), (path, mod)   # absolute imports only


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys, repro_torch.launch.serve, repro_torch.core, "
            "repro_torch.launch.train, repro_torch.training, "
            "repro_torch.optim, repro_torch.bridge, repro_torch.checkpoint, "
            "repro_torch.obs.costs, repro_torch.trajectory, "
            "repro_torch.distributed, repro_torch.examples.quickstart, "
            "repro_torch.examples.serve_decode, repro_torch.kernels, "
            "repro_torch.serving, repro_torch.core.grow_cache, "
            "repro_torch.autogrow, repro_torch.data, repro_torch.configs, "
            "repro_torch.kernels._build as b; "
            "assert not any(m in ('jax', 'ml_dtypes') "
            "or m.startswith(('jax.', 'repro.', 'ml_dtypes.')) "
            "for m in sys.modules), sorted(sys.modules); "
            "assert not b._LIBS and not b.BUILD_LOG")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# Names of a JAX package's ``__all__`` that its port leaves out, each with
# the ROADMAP item that rules it out of this port or schedules it.
MESH = "ROADMAP 1.3, the mesh machinery (TPU-pod / multi-chip, out of scope)"
DRYRUN = ("ROADMAP 1.3, the XLA dry run (launch/dryrun.py is their only "
          "user; out of scope)")
S1 = "ROADMAP 2, speed item S1 (the compiled LiGO step)"
TPU_VMEM = "ROADMAP 1.3, TPU VMEM sizing of the Pallas kernels (no Hopper use)"
OUT_OF_SCOPE = {
    "autogrow": {},
    "checkpoint": {},
    "configs": {n: DRYRUN for n in (
        "ALL_SHAPES", "Cell", "DECODE_32K", "LONG_500K", "PREFILL_32K",
        "SHAPES", "ShapeConfig", "TRAIN_4K", "cell_status",
        "enumerate_cells")},
    "core": {"TRACE_COUNTS": S1, "place_operator": MESH},
    "data": {},
    "distributed": {n: MESH for n in (
        "P", "batch_specs", "divisible_axes", "maybe_shard",
        "named_shardings", "params_pspecs", "physical_spec")},
    "kernels": {"fused_eligible": TPU_VMEM, "fused_vmem_bytes": TPU_VMEM,
                "ligo_blend_expand_grouped_sharded": MESH},
    "models": {},
    "obs": {},
    "optim": {"compression": MESH},
    "roofline": {"collect_hlo_stats": MESH},
    "serving": {},
    "training": {"pjit_train_step": MESH, "train_state_shardings": MESH},
    "trajectory": {},
}


@pytest.mark.parametrize("pkg", sorted(OUT_OF_SCOPE))
def test_port_exports_the_reference_surface(pkg):
    """Each port package's ``__all__`` holds the JAX package's, less the
    names listed above with their ROADMAP items — exactly those."""
    import importlib
    pytest.importorskip("jax")
    ours = importlib.import_module(f"repro_torch.{pkg}")
    theirs = importlib.import_module(f"repro.{pkg}")
    missing = set(theirs.__all__) - set(ours.__all__)
    assert missing == set(OUT_OF_SCOPE[pkg]), sorted(missing)
    for name in ours.__all__:
        assert hasattr(ours, name), name
    if pkg == "autogrow":
        assert list(ours.__all__) == list(theirs.__all__)
