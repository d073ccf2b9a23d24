"""The port does all that the JAX package does, name for name: an AST scan
of every module of ``ash_renderer_tpu/`` (its source is read; nothing of
it is imported) lists each public top-level name, and each must exist in
the port's counterpart module or stand in ``NOT_PORTED`` with its reason.

Public names: top-level functions, classes and assigned names, and the
names a package's ``__init__.py`` imports from its own modules; a leading
underscore makes a name private, and dtype aliases (``F32 = np.float32``)
are spelling, not function.  ``MOVED`` maps a reference module to the
port's module of another name.

The scan also takes the public methods of each public class (``Class.name``
in ``NOT_PORTED``), and the JAX package's scripts: the files of the repo
root and of ``examples/`` that import the package.  ``bench.py``'s
counterpart is ``bench_torch.py``, ``examples/X.py``'s is
``examples/torch_X.py``; each has the reference script's public functions
and imports neither jax nor the JAX package, or the script stands in
``SCRIPTS_NOT_PORTED`` with its reason."""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "ash_renderer_tpu")

MOVED = {
    # the Pallas module's name; the port's kernel is CUDA (csrc/raster_classic.cu)
    "ops/raster_pallas.py": "ops/raster_visibility.py",
}

# (reference module, name): why the port has no such name.  None of these
# changes a frame's bits.
NOT_PORTED = {
    ("pipeline.py", "render_frame_staged"):
        "the classic frame split into separately jitted stages for XLA "
        "compile time; the port's render_frame is one torch function",
    ("pipeline.py", "render_frame_jit"):
        "the classic frame as one jit; torch runs render_frame as it is",
    ("pipeline.py", "render_frame_fused_jit"):
        "the fused frame as one jit; torch runs render_frame_fused_staged "
        "as it is",
    ("pipeline.py", "sort_expand_table"):
        "restructured: binsort.sort_and_bounds, then pipeline.expand_table",
    ("pipeline.py", "sm_bitcast"):
        "a jax bitcast helper; the port has specmath.bitcast_f32",
    ("renderer.py", "select_device"):
        "platform scoring picks a device; the port never picks one "
        "(renderer.resolve_device honours preferred_device_index)",
    ("ops/tritables.py", "sorted_table_budgeted"):
        "lax.switch budget tiers for XLA's static shapes; the port's "
        "sorted_table gathers the live prefix",
    ("ops/tritables.py", "budget_cuts"):
        "the tier sizes of sorted_table_budgeted",
    ("rtypes.py", "register_pytree_dataclass"):
        "JAX pytree registration; torch needs none",
    ("native.py", "write_png"):
        "the C++ PNG writer; the stdlib present.encode_png takes its place",
    ("ops/shade.py", "interp_fields"):
        "restructured: interp_fields_stacked (channels stacked); "
        "oracle/shade_np.py keeps the reference's name",
    ("ops/shade.py", "shade_surface"):
        "restructured: surface_prelight + combine_from_prelight, shared "
        "with phase F; oracle/shade_np.py keeps the reference's name",
    ("specmath.py", "fill_bias"):
        "the torch and CUDA rasterizers test E >= 1 - is_top_left, the same "
        "predicate without the add; oracle/specmath_np.py keeps the "
        "reference's fill_bias",
    ("ops/fused_kernel.py", "GRP_T"):
        "the Pallas kernel's sublane group of triangles per visibility "
        "evaluation; csrc/raster.cu has its own layout",
    ("ops/fused_kernel.py", "PLANE_ROWS"):
        "the Pallas kernel's VMEM accumulator rows; csrc/raster.cu has its "
        "own layout",
}

_DTYPES = {"float32", "float16", "int8", "int16", "int32", "int64", "uint8",
           "uint16", "uint32", "bool_"}


def _is_dtype_alias(value) -> bool:
    return (isinstance(value, ast.Attribute) and value.attr in _DTYPES
            and isinstance(value.value, ast.Name)
            and value.value.id in ("np", "jnp"))


def public_methods(path: str) -> set:
    """``Class.method`` for each public function defined in the body of a
    public top-level class."""
    tree = ast.parse(open(path).read(), path)
    return {f"{c.name}.{f.name}" for c in tree.body
            if isinstance(c, ast.ClassDef) and not c.name.startswith("_")
            for f in c.body
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not f.name.startswith("_")}


def public_names(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    init = os.path.basename(path) == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            if _is_dtype_alias(node.value):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif init and isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def reference_modules() -> list:
    out = []
    for d, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(d, f), REF)
                for f in files if f.endswith(".py")]
    return sorted(out)


def port_module(rel: str):
    rel = MOVED.get(rel, rel)[: -len(".py")]
    parts = [p for p in rel.split("/") if p != "__init__"]
    return importlib.import_module(".".join(["ash_renderer_tpu_torch", *parts]))


MODULES = reference_modules()


def test_scan_sees_the_whole_package():
    assert len(MODULES) >= 30
    for rel in ("__init__.py", "renderer.py", "ops/binsort.py",
                "utils/debugging.py", "parallel/sharding.py"):
        assert rel in MODULES
    assert {"Camera", "RendererSettings", "Scene"} <= public_names(
        os.path.join(REF, "__init__.py"))
    assert {"bin_sort", "stream_ranges_host", "N_GRP"} <= public_names(
        os.path.join(REF, "ops", "binsort.py"))


def port_has(rel: str, name: str) -> bool:
    """Whether the port's counterpart of ``rel`` has ``name`` (a dotted
    ``Class.method`` is looked up on the port's class)."""
    obj = port_module(rel)
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_is_ported(rel):
    mod = port_module(rel)
    missing = sorted(n for n in public_names(os.path.join(REF, rel))
                     if not hasattr(mod, n) and (rel, n) not in NOT_PORTED)
    assert not missing, f"{rel}: not in {mod.__name__}: {missing}"


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_method_is_ported(rel):
    """The public methods of the reference's public classes (the scan of
    top-level names cannot see a missing ``Renderer.warmup``)."""
    missing = sorted(
        n for n in public_methods(os.path.join(REF, rel))
        if (rel, n) not in NOT_PORTED and (rel, n.split(".")[0]) not in NOT_PORTED
        and not port_has(rel, n))
    assert not missing, f"{rel}: not in the port's classes: {missing}"


@pytest.mark.parametrize("rel,name", sorted(NOT_PORTED))
def test_not_ported_table_is_exact(rel, name):
    """Each entry names a public name (or method) of the reference that the
    port lacks: a name the port gains, or the reference loses, must leave
    the table."""
    path = os.path.join(REF, rel)
    assert name in public_names(path) | public_methods(path)
    assert not port_has(rel, name)


# ---------------------------------------------------------------------------
# the JAX package's scripts
# ---------------------------------------------------------------------------

SCRIPTS_NOT_PORTED = {
    "__graft_entry__.py":
        "the JAX package's single-chip compile check and multi-chip dry run "
        "on XLA's virtual CPU devices; the port's row slabs are checked by "
        "chip_smoke.py phases 4 and 19 and tests/test_torch_sharding*.py",
}


def imported_roots(path: str) -> set:
    """The top-level package of every module ``path`` imports, at any
    depth of its code."""
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def reference_scripts() -> list:
    out = []
    for d in ("", "examples"):
        for f in sorted(os.listdir(os.path.join(ROOT, d) if d else ROOT)):
            rel = os.path.join(d, f)
            if (f.endswith(".py")
                    and "ash_renderer_tpu" in imported_roots(os.path.join(ROOT, rel))):
                out.append(rel)
    return out


def port_script(rel: str) -> str:
    if rel == "bench.py":
        return "bench_torch.py"
    d, f = os.path.split(rel)
    return os.path.join(d, "torch_" + f)


def public_functions(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not n.name.startswith("_")}


SCRIPTS = reference_scripts()


def test_script_scan_sees_the_entry_points():
    assert set(SCRIPTS) == {"bench.py", "__graft_entry__.py",
                            "examples/render_scene.py",
                            "examples/inverse_rendering.py",
                            "examples/interactive.py"}
    assert {"parity_gate", "headline_hash_gate", "flyby_path", "sweep",
            "main"} <= public_functions(os.path.join(ROOT, "bench.py"))


@pytest.mark.parametrize("rel", [s for s in SCRIPTS
                                 if s not in SCRIPTS_NOT_PORTED])
def test_every_script_has_a_jax_free_counterpart(rel):
    port = os.path.join(ROOT, port_script(rel))
    assert os.path.exists(port), f"{rel}: no {port_script(rel)}"
    missing = sorted(public_functions(os.path.join(ROOT, rel))
                     - public_functions(port))
    assert not missing, f"{port_script(rel)} lacks {missing} of {rel}"
    roots = imported_roots(port)
    assert not roots & {"jax", "jaxlib", "ash_renderer_tpu"}, roots
    assert "ash_renderer_tpu_torch" in roots


@pytest.mark.parametrize("rel", sorted(SCRIPTS_NOT_PORTED))
def test_scripts_not_ported_table_is_exact(rel):
    assert rel in SCRIPTS
    assert not os.path.exists(os.path.join(ROOT, port_script(rel)))
