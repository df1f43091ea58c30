"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and
``chip_kernel_ab.py`` import neither JAX nor anything of the JAX package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "chip_kernel_ab.py"]
# the training slice's modules: each must be imported by the probe and
# scanned by the AST check
TRAIN_SLICE = ["repro_torch.train.train_loop", "repro_torch.train.optimizer",
               "repro_torch.train.checkpoint", "repro_torch.train.losses",
               "repro_torch.data.pipeline",
               "repro_torch.distributed.fault_tolerance",
               "repro_torch.launch.train",
               "repro_torch.kernels.flash_attention"]
# the mamba2 slice's modules, likewise
MAMBA_SLICE = ["repro_torch.models.mamba", "repro_torch.kernels.ssd_scan",
               "repro_torch.configs.mamba2_1_3b"]
# the options slice's modules (events, task classes, configs, int8 weights)
OPTIONS_SLICE = ["repro_torch.core.events", "repro_torch.core.task_class",
                 "repro_torch.configs.shapes", "repro_torch.configs.qwen2_5_3b",
                 "repro_torch.configs.llama3_405b",
                 "repro_torch.serve.quantization"]

# the collectives slice's modules
COLLECTIVES_SLICE = ["repro_torch.collectives",
                     "repro_torch.collectives.schedules",
                     "repro_torch.collectives.compression",
                     "repro_torch.collectives.nonblocking",
                     "repro_torch.collectives.p2p",
                     "repro_torch.collectives.overlap",
                     "repro_torch.launch.mesh"]
# the per-device mesh: its payload type (and the modules above, extended)
DEVICES_SLICE = ["repro_torch.collectives.rank_shards"]
# the parallel-training slice's modules
PARALLEL_SLICE = ["repro_torch.sharding", "repro_torch.distributed.elastic",
                  "repro_torch.distributed.pipeline"]
# the parallel-serving slice's modules
SERVE_SLICE = ["repro_torch.serve.engine", "repro_torch.serve.kvcache",
               "repro_torch.launch.serve", "repro_torch.models.registry",
               "repro_torch.models.transformer"]
# the MoE slice: its configs, and the modules that hold its code (the MoE
# layer, its expert-parallel path and the capped attention kernels)
MOE_SLICE = ["repro_torch.configs.granite_moe_3b_a800m",
             "repro_torch.configs.grok1_314b", "repro_torch.models.layers",
             "repro_torch.kernels.decode_attention", "repro_torch.kernels.ops"]
# the slice of the last three families: hybrid, encoder-decoder and the
# vlm backbone (the transformer), and their configs
FAMILIES_SLICE = ["repro_torch.models.hybrid", "repro_torch.models.encdec",
                  "repro_torch.configs.zamba2_1_2b",
                  "repro_torch.configs.whisper_tiny",
                  "repro_torch.configs.pixtral_12b"]
# the model-axis slice: ring attention (the MoE block's tensor-parallel
# schedule lives in models.layers, scanned above)
CONTEXT_SLICE = ["repro_torch.collectives.ring_attention"]
# the steps, dry-run, analysis and examples slice
STEPS_SLICE = ["repro_torch.launch.steps", "repro_torch.launch.dryrun",
               "repro_torch.analysis.opcount", "repro_torch.analysis.roofline",
               "repro_torch.analysis.report",
               "repro_torch.analysis.progress_lint",
               "repro_torch.examples.quickstart",
               "repro_torch.examples.train_lm", "repro_torch.examples.serve_lm",
               "repro_torch.examples.user_collectives",
               "repro_torch.examples.progress_engine_tour"]
MOE_NAMES = ["training_mode", "in_training", "moe_spec", "_moe_route",
             "moe_apply", "moe_dispatch_alltoall", "_moe_expert_ffn_sharded",
             "moe_apply_expert_parallel"]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
print("MODULES", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
print("LOADED", sorted(n for n in sys.modules if n.startswith("repro_torch")))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 30          # every submodule was imported
    assert lines["BAD"] == "[]"
    loaded = lines["LOADED"]
    assert all(f"'{m}'" in loaded
               for m in TRAIN_SLICE + MAMBA_SLICE + OPTIONS_SLICE
               + COLLECTIVES_SLICE + PARALLEL_SLICE + SERVE_SLICE
               + MOE_SLICE + FAMILIES_SLICE + CONTEXT_SLICE
               + STEPS_SLICE + DEVICES_SLICE), loaded


def test_the_moe_slice_is_in_the_port():
    """The MoE layer's functions live in the port's ``layers`` (whose
    source the AST check below holds to no JAX import), and its registry
    takes the moe family into the transformer."""
    import inspect

    from repro_torch.configs import get_config
    from repro_torch.models import layers, registry, transformer
    for name in MOE_NAMES:
        fn = getattr(layers, name)
        assert inspect.getsourcefile(inspect.unwrap(fn)) == \
            str(PORT / "models" / "layers.py")
    for arch in ("granite-moe-3b-a800m", "grok-1-314b"):
        assert registry.module_for(get_config(arch)) is transformer


def test_every_family_maps_to_a_module_of_the_port():
    """The registry takes each of the JAX registry's six families into a
    module of the port, whose source the AST check holds to no JAX
    import."""
    import inspect

    from repro_torch.configs import get_config, list_configs
    from repro_torch.models import registry
    families = set()
    for arch in list_configs():
        cfg = get_config(arch)
        families.add(cfg.family)
        src = Path(inspect.getsourcefile(registry.module_for(cfg)))
        assert PORT in src.parents, (arch, src)
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "audio"}


def _imported(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_jax_or_repro_import_in_the_sources():
    assert len(SOURCES) >= 30
    scanned = {".".join(p.relative_to(PORT.parent).with_suffix("").parts)
               for p in SOURCES if PORT in p.parents}
    assert set(TRAIN_SLICE + MAMBA_SLICE + OPTIONS_SLICE
               + COLLECTIVES_SLICE[1:] + PARALLEL_SLICE
               + SERVE_SLICE + FAMILIES_SLICE + CONTEXT_SLICE
               + STEPS_SLICE + DEVICES_SLICE) <= scanned
    assert "repro_torch.collectives.__init__" in scanned
    for path in SOURCES:
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
