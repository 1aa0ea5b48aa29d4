"""Nothing the benchmark runs on the chip imports `jax` or the JAX
package, and the reference imports nothing of the program: top-level
module names (the part before the first dot) compared whole, since
`trafficsimulation_tpu_torch` begins with `trafficsimulation_tpu`."""

import ast
import subprocess
import sys

from tsim_bench.common import FORBIDDEN, HERE, ROOT, forbidden_loaded

PROGRAM = "trafficsimulation_tpu_torch"


def imported(path) -> set:
    """The top-level names of the absolute imports of a source file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    return sorted(p for p in (HERE / sub).rglob("*.py")
                  if "tests" not in p.relative_to(HERE).parts)


def test_whole_names():
    assert forbidden_loaded(["trafficsimulation_tpu_torch.sim", "jaxtyping",
                             "numpy"]) == []
    assert forbidden_loaded(["trafficsimulation_tpu.sim", "jax.numpy",
                             "flax", "jaxlib.xla"]) == [
        "flax", "jax.numpy", "jaxlib.xla", "trafficsimulation_tpu.sim"]


def test_no_jax_in_the_harness():
    for p in sources():
        names = imported(p)
        assert not names & set(FORBIDDEN), (p, names & set(FORBIDDEN))


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        names = imported(p)
        assert not names & (set(FORBIDDEN) | {PROGRAM, "tsim_bench"}), \
            (p, names)


def test_reference_registers_no_operator():
    """The reference defines no torch operator, so that it can share a
    process with the program without clashing with the program's."""
    for p in sources("reference"):
        text = p.read_text()
        for word in ("torch.library", "custom_op", "register_fake",
                     "autograd.Function"):
            assert word not in text, (p, word)


def test_loaded_modules_of_a_reference_process():
    """The reference, imported and run for a tick in a fresh process,
    loads neither the program nor JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from tsim_bench.common import Pkg, REFERENCE\n"
        "ref = Pkg(REFERENCE)\n"
        "cfg = ref.make_config(dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6,"
        " SIDEWALK_RING_WIDTH=2, MAX_FIELD_DESTS=32, MAX_VEHICLES=256))\n"
        "w = ref.sim.init_world(cfg, ref.prng.PRNGKey(3), 'cpu')\n"
        "w = ref.sim.run_chunk(cfg, w, 1)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'trafficsimulation_tpu', %r))\n"
        "print('BAD', bad)\n") % (str(ROOT), PROGRAM)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_the_harness_loads_no_jax():
    """The harness's modules and the program, imported in a fresh process
    as run.py imports them, load no JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import tsim_bench.harness, tsim_bench.check\n"
        "from tsim_bench.common import (Pkg, PROGRAM, module,\n"
        "                               forbidden_loaded)\n"
        "p = Pkg(PROGRAM); p.sim; p.mesh; p.HE\n"
        "for m in ('launches_per_tick', 'device_idle_share', "
        "'torch_op_ms_per_tick', 'routing_ms_per_tick', "
        "'k1_roofline_share', 'k9_roofline_share'):\n"
        "    module('metrics', m)\n"
        "print('BAD', forbidden_loaded(sys.modules))\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
