"""Hygiene of the port: import isolation, the device rule, no hidden
fallback from a kernel to its plain version, and no refusal left: every
feature of the JAX package that was refused until its slice came runs."""

import ast
import dataclasses
import inspect
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import mloam_tpu_torch
from mloam_tpu_torch import config as C
from mloam_tpu_torch.models import pipeline as P
from mloam_tpu_torch.models import platforms, run_synthetic
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.odometry import estimator as E
from mloam_tpu_torch.ops import hopper_band_chol, hopper_knn, hopper_labels
from mloam_tpu_torch.ops import knn as knn_ops
from mloam_tpu_torch.sim import world as W

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mloam_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mloam_tpu", "flax", "optax")


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PKG.rglob("*.py") if p.name != "__init__.py"]
    code = textwrap.dedent(f"""
        import importlib, sys
        import mloam_tpu_torch
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'jaxlib', 'mloam_tpu')]
        assert not bad, bad
        import torch
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        print('clean', len(sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_kernel_sources_are_in_the_package():
    names = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert names == ["band_chol.cu", "knn.cu", "labels.cu"]
    for n in names:
        text = (PKG / "csrc" / n).read_text()
        assert "torch/extension.h" not in text and "__global__" in text
        assert "cudaGetLastError" in text


# ---------------------------------------------------------------- device rule

def _no_gpu():
    return not torch.cuda.is_available()


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked_for():
    if not _no_gpu():
        pytest.skip("needs a machine without a CUDA device")
    cfg = platforms.synthetic()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.OdometryPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_synthetic.run(n_frames=2, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_synthetic.render(cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_synthetic.render_rig(platforms.synthetic(n_lidars=2), 1)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        W.make_world(g)
    w = W.make_world(g, device="cpu")
    t = W.make_trajectory(g, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        W.render_sequence(w, t, cfg.rig.models[0], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mloam_tpu_torch.resolve_device(None)
    assert mloam_tpu_torch.resolve_device("cpu").type == "cpu"
    assert P.OdometryPipeline(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        P.SlamPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.SlamPipeline(cfg, loop_capacity=4, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_synthetic.run(n_frames=2, verbose=False, slam=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        W.make_loop_trajectory()
    small = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=2, cap_map_corner=8, cap_map_surf=8))
    slam = P.SlamPipeline(small, loop_capacity=4, device="cpu")
    assert slam.device.type == "cpu" and slam.full.device.type == "cpu"
    assert slam.loop_state.valid.device.type == "cpu" and slam.loop_state.valid.shape == (4,)


def test_full_pipeline_defaults_to_the_gpu_and_raises_without_one():
    """``FullPipeline(cfg)`` with no device resolves to ``cuda``, as
    ``OdometryPipeline`` does, and raises here; on the CPU only when asked."""
    if not _no_gpu():
        pytest.skip("needs a machine without a CUDA device")
    cfg = platforms.synthetic()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.FullPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.FullPipeline(cfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_synthetic.run(n_frames=2, verbose=False, mapping=True)
    small = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=2, cap_map_corner=8, cap_map_surf=8))
    pipe = P.FullPipeline(small, device="cpu")
    assert pipe.device.type == "cpu" and pipe.odom.device.type == "cpu"
    assert pipe.mapper_state.db.valid.device.type == "cpu"


def test_the_mapping_modules_are_scanned_for_imports():
    """The import scan covers the modules the mapping and loop-closure slices
    add."""
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if p.is_relative_to(PKG)}
    assert {"core/uncertainty.py", "core/cloud.py", "mapping/keyframes.py",
            "mapping/mapper.py", "solver/feature_selection.py"} <= names
    assert {"loop/__init__.py", "loop/scancontext.py", "loop/registration.py",
            "loop/global_registration.py", "loop/posegraph.py",
            "parallel/__init__.py", "parallel/sharded_pgo.py"} <= names


def test_world_is_deterministic_in_the_generator():
    a = W.make_world(torch.Generator().manual_seed(5), device="cpu")
    b = W.make_world(torch.Generator().manual_seed(5), device="cpu")
    c = W.make_world(torch.Generator().manual_seed(6), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.rect_center, c.rect_center)
    assert a.rect_center.shape == (25, 3) and a.cyl_xyr.shape == (12, 3)


# ------------------------------------------------------- no hidden fallback

def _has_try(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.mark.parametrize("fn", [hopper_labels.propagate_labels, hopper_knn.knn,
                                knn_ops.knn, knn_ops.knn_auto,
                                hopper_band_chol.band_solve, hopper_band_chol.solve],
                         ids=["hopper_labels.propagate_labels", "hopper_knn.knn",
                              "knn.knn", "knn.knn_auto", "hopper_band_chol.band_solve",
                              "hopper_band_chol.solve"])
def test_kernel_wrappers_have_no_try_around_the_launch(fn):
    assert not _has_try(fn)


def test_cuda_tensors_cannot_reach_the_plain_versions():
    """Read the wrappers: the plain version is taken only under
    ``not is_cuda`` / after an ``is_cuda`` return, and the kernel path ends in
    the launch check."""
    src = inspect.getsource(hopper_labels.propagate_labels)
    head, tail = src.split("if not labels.is_cuda:")
    assert "propagate_labels_plain" not in head
    branch, rest = tail.split("global launches")
    assert branch.count("propagate_labels_plain") == 1
    assert "propagate_labels_plain" not in rest
    # the counter takes the number of launches the C entry reports, nothing else
    assert "_build.check(err" in rest
    assert rest.count("launches +=") == 1 and "launches += n_launched.value" in rest

    src = inspect.getsource(knn_ops.knn)
    assert src.index("if q.is_cuda:") < src.index("return hopper_knn.knn(") < src.index("knn_plain(")
    src = inspect.getsource(hopper_knn.knn)
    assert "knn_plain" not in src and "_build.check(err" in src
    assert src.count("launches +=") == 1

    src = inspect.getsource(hopper_band_chol.solve)
    assert (src.index("if band.is_cuda:") < src.index("return band_solve(")
            < src.index("band_solve_plain("))
    src = inspect.getsource(hopper_band_chol.band_solve)
    assert "band_solve_plain" not in src and "_build.check(err" in src
    assert src.count("launches +=") == 1


def test_a_meta_cuda_call_raises_instead_of_falling_back(monkeypatch):
    """A CUDA-typed call on a machine that cannot build the kernel must raise,
    not compute something else: fake ``is_cuda`` on CPU data and make the
    build fail."""
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    from mloam_tpu_torch.ops import _build

    def boom(stem):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(hopper_knn, "_fn", None)
    monkeypatch.setattr(hopper_labels, "_fn", None)
    q = torch.zeros(4, 3).as_subclass(FakeCuda)
    r = torch.zeros(5, 3)
    m = torch.ones(5, dtype=torch.bool)
    before = hopper_knn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        knn_ops.knn(q, r, m, 2)
    assert hopper_knn.launches == before
    lab = torch.zeros(2, 8, dtype=torch.int32).as_subclass(FakeCuda)
    c = torch.zeros(2, 8, dtype=torch.bool)
    before = hopper_labels.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        hopper_labels.propagate_labels(lab, c, c, 3)
    assert hopper_labels.launches == before


@pytest.mark.parametrize("shape", [(64, 4000), (2, 40000)], ids=["smem", "int16_runs"])
def test_label_kernel_refuses_an_image_too_large_before_any_build(monkeypatch, shape):
    """An image whose cluster block does not fit in shared memory (or whose
    run starts overflow int16) raises ValueError naming the limit, before the
    kernel is built or launched: there is no fallback."""
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    from mloam_tpu_torch.ops import _build

    def boom(stem):
        raise AssertionError("the kernel must not be built for this image")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(hopper_labels, "_fn", None)
    lab = torch.zeros(shape, dtype=torch.int32).as_subclass(FakeCuda)
    c = torch.zeros(shape, dtype=torch.bool)
    before = hopper_labels.launches
    with pytest.raises(ValueError, match="232448|32767"):
        hopper_labels.propagate_labels(lab, c, c, 3)
    assert hopper_labels.launches == before


def test_build_module_does_nothing_at_import_and_fails_loudly():
    from mloam_tpu_torch.ops import _build

    assert [p.name for p in _build.sources()] == ["band_chol.cu", "knn.cu", "labels.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(RuntimeError, match="error code 7"):
        _build.check(7, "x")
    _build.check(0, "x")


# ------------------------------------------------- narrowed features raise

def _cfg(**odo):
    cfg = platforms.synthetic()
    return dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, **odo))


def _pgo_mesh():
    from mloam_tpu_torch.parallel import mesh as M
    from mloam_tpu_torch.parallel import sharded_pgo as PG

    poses = Pose.identity((2,), device="cpu")
    edges = PG.PoseGraphEdges(torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=torch.int64),
                              poses.q[:1], poses.t[:1], torch.ones(1, 6))
    return PG.optimize_pose_graph(poses, edges, mesh=M.make_mesh(2, device="cpu"))


# what the port refused until the last slice: the edge-sharded PGO across
# devices; nothing is refused now
NARROWED = {"pgo_mesh": _pgo_mesh}


@pytest.mark.parametrize("name", sorted(NARROWED))
def test_narrowed_feature_raises_not_implemented(name):
    """The once-narrowed features no longer raise ``NotImplementedError``:
    each runs to a finite result."""
    out = NARROWED[name]()
    assert torch.isfinite(out.t).all() and torch.isfinite(out.q).all()


def test_no_refusal_is_left_but_the_mesh():
    """No ``raise NotImplementedError`` is left in the package: the last one,
    ``optimize_pose_graph(mesh=)``'s, went with the distributed slice."""
    raises = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Raise) and "NotImplementedError" in ast.unparse(node):
                raises.append(str(path.relative_to(PKG)))
    assert raises == []


def _armed_window_step(cfg):
    w = E.init_window(cfg, 8, 8, device="cpu")
    w, solve = E.optimize_window(w, cfg)
    return E.marginalize_pivot(w, solve, cfg)


# what earlier slices refused and this one ports: each constructs and runs
PORTED = {
    "eig_threshold": lambda: P.OdometryPipeline(_cfg(eig_threshold=175.0), device="cpu"),
    "indoor_degenerate": lambda: P.OdometryPipeline(
        platforms.indoor_degenerate(platforms.synthetic()), device="cpu"),
    "window_loss_gm": lambda: P.OdometryPipeline(_cfg(loss_mode="gm"), device="cpu"),
    "tracker_loss_gnc": lambda: P.OdometryPipeline(
        C.with_loss_mode(platforms.synthetic(), "gnc_gm"), device="cpu"),
    "skip_steady": lambda: P.OdometryPipeline(dataclasses.replace(
        platforms.synthetic(), tracker=dataclasses.replace(
            platforms.synthetic().tracker, skip_steady=True)), device="cpu"),
    "analytic_false": lambda: E.optimize_window(
        E.init_window(platforms.synthetic(), 8, 8, device="cpu"),
        platforms.synthetic(), analytic=False),
    "marginalize_armed_gate": lambda: _armed_window_step(_cfg(eig_threshold=175.0)),
    "world_fixtures": lambda: (W.make_corridor_world(device="cpu"),
                               W.make_straight_trajectory(device="cpu")),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_formerly_narrowed_feature_runs(name):
    assert PORTED[name]() is not None


def test_presets_not_ported_are_absent_not_silently_different():
    """Every preset and operating point of the JAX package has its
    counterpart (none is left absent), and the fixture's widths are the
    reference's."""
    from mloam_tpu.models import platforms as jplatforms

    names = {n for n, f in vars(jplatforms).items()
             if inspect.isfunction(f) and not n.startswith("_")
             and f.__module__ == jplatforms.__name__}
    assert names and all(callable(getattr(platforms, n, None)) for n in names), \
        sorted(n for n in names if not hasattr(platforms, n))
    cfg = platforms.synthetic()
    assert cfg.odometry.cap_frame_corner == 1024 and cfg.odometry.cap_frame_surf == 2048
    assert cfg.features.cap_less_flat == 4096 and cfg.rig.models[0].n_cols == 1800
    two = platforms.synthetic(n_lidars=2)
    assert two.odometry.cap_frame_corner == 384 and two.odometry.localmap_precap_surf == 3840


PRESETS = {
    **{name: (lambda pl, name=name: getattr(pl, name)())
       for name in ("simu_jackal", "handheld", "vehicle_hercules", "oxford", "kitti")},
    "realtime_tuned_synthetic_1": lambda pl: pl.realtime_tuned(pl.synthetic(1)),
    "realtime_tuned_synthetic_2_0": lambda pl: pl.realtime_tuned(pl.synthetic(2, 0)),
    "indoor_degenerate_synthetic_1": lambda pl: pl.indoor_degenerate(pl.synthetic(1)),
    "indoor_degenerate_realtime_tuned_2_0": lambda pl: pl.indoor_degenerate(
        pl.realtime_tuned(pl.synthetic(2, 0))),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_ported_presets_equal_the_reference_presets(name):
    """Field by field, sensor models (the HDL-64 ring table) included."""
    from mloam_tpu.models import platforms as jplatforms

    t, j = PRESETS[name](platforms), PRESETS[name](jplatforms)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert type(t.rig.models[0]).__module__.startswith("mloam_tpu_torch")


# --------------------------------------------- the deployment layer (host)

def test_the_host_source_is_in_the_package_and_built_apart_from_nvcc():
    from mloam_tpu_torch.ops import _build

    assert [p.name for p in (PKG / "csrc").glob("*.cpp")] == ["dataset.cpp"]
    text = (PKG / "csrc" / "dataset.cpp").read_text()
    assert 'extern "C"' in text and "__global__" not in text and "#include <cuda" not in text
    assert "-pthread" in _build.HOST_CXX_FLAGS and "-shared" in _build.HOST_CXX_FLAGS
    assert all(p.suffix == ".cu" for p in _build.sources())
    assert _build.BUILD_DIR.parent == PKG and _build.CSRC.parent == PKG


_FILE_CALLS = {"open", "load", "fromfile", "loadtxt", "CDLL", "LoadLibrary", "join",
               "Path", "glob", "rglob", "listdir", "exists", "isfile", "read_text",
               "read_bytes", "run", "Popen"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_opens_or_loads_a_file_of_the_jax_package(path):
    """No call that opens, loads, lists or builds a path is handed one in
    the JAX package (a ``file:line`` reference in a report is not such a
    call), and nothing names the JAX package's native library."""
    import re

    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if name not in _FILE_CALLS:
            continue
        for arg in ast.walk(node):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and (
                    re.search(r"(^|[/\\])mloam_tpu([/\\]|$)", arg.value)
                    or arg.value == "native"):
                bad.append(ast.unparse(node))
    text = path.read_text()
    assert not bad and "libmloam_native" not in text and "native/dataset" not in text, bad


def test_the_host_build_does_nothing_at_import_and_fails_loudly(monkeypatch, tmp_path):
    code = textwrap.dedent("""
        import mloam_tpu_torch.utils.dataio as D
        from mloam_tpu_torch.ops import _build
        import mloam_tpu_torch.models.experiments, mloam_tpu_torch.utils.checkpoint
        assert D._lib is None and not _build._libs
        print('nothing built')
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "", "CXX": "/nonexistent"})
    assert out.returncode == 0 and "nothing built" in out.stdout, out.stderr

    from mloam_tpu_torch.ops import _build
    from mloam_tpu_torch.utils import dataio

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(dataio, "_lib", None)
    monkeypatch.setenv("CXX", "false")        # a compiler that always fails
    with pytest.raises(RuntimeError, match="host C.. build failed"):
        dataio.library()
    with pytest.raises(RuntimeError, match="host C.. build failed"):
        dataio.read_kitti_bin(str(tmp_path / "x.bin"))
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C.. compiler"):
        dataio.library()
    with pytest.raises(RuntimeError, match="no host source"):
        _build.load_host("absent")
    assert not list(tmp_path.glob("*.so"))


def test_experiments_register_no_scaling_program():
    """The ``scaling`` program, refused until the distributed slice, is
    registered now, and like every program runs on the GPU: without one it
    raises rather than carrying on on the CPU."""
    from mloam_tpu_torch.models import experiments as X

    assert callable(X.measure_scaling) and callable(X.write_scaling)
    if not _no_gpu():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        X.main(["scaling", "--poses", "8"])


def test_the_deployment_entry_points_default_to_the_gpu():
    if not _no_gpu():
        pytest.skip("needs a machine without a CUDA device")
    from mloam_tpu_torch.models import experiments as X

    for call in (lambda: X.measure_single(2), lambda: X.measure_corridor(2),
                 lambda: X.measure_dynamic(2), lambda: X.run_sequence(platforms.synthetic(), 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------- the real-data programs and the report

_TPU_CONSTANTS = ("ICI_BW", "DCN_BW", "VPU_FLOPS", "2.0e12", "2e12", "45e9", "6e9")


@pytest.mark.parametrize("rel", ["parallel/scaling_model.py", "models/realdata.py",
                                 "models/experiments.py"])
def test_the_report_and_the_programs_name_no_tpu_constant_and_no_reference_path(rel):
    """The scaling report takes its fabric from the caller (``Fabric``), and
    the programs read the directory they are given: no TPU rate or
    bandwidth, and no path to the reference's data on the machine the JAX
    package was measured on."""
    text = (PKG / rel).read_text()
    bad = [c for c in _TPU_CONSTANTS if c in text]
    assert not bad, bad
    assert "reference/mloam_test" not in text and "REF_DATA" not in text


# ------------------------------------------------- what leaves the default run

def _slow_node_ids():
    """``SLOW`` of the root conftest.py: the node ids that get ``slow``."""
    tree = ast.parse((ROOT / "conftest.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["SLOW"]):
            return ast.literal_eval(node.value)
    raise AssertionError("conftest.py defines no SLOW")


def _marks_slow(tree):
    return any(isinstance(n, ast.Attribute) and n.attr == "slow"
               and isinstance(n.value, ast.Attribute) and n.value.attr == "mark"
               for n in ast.walk(tree))


def _port_importers(tests_dir):
    """The test modules that import the port, directly or through a helper
    module of the test directory (``torch_*_case.py``)."""
    local = {p.stem: p for p in tests_dir.glob("*.py")}
    roots = {name: set(_imported_roots(p)) for name, p in local.items()}
    found = {name for name, r in roots.items() if "mloam_tpu_torch" in r}
    while True:
        more = {name for name, r in roots.items() if r & found} - found
        if not more:
            return found
        found |= more


def test_slow_leaves_out_only_tests_of_the_jax_package():
    """``-m 'not slow'`` is tier-1: a test of the port that carried ``slow``
    would leave it unnoticed. Only the JAX package's own test files may,
    whether ``SLOW`` names them or they carry the mark themselves."""
    tests_dir = ROOT / "tests"
    slow = {pathlib.Path(n.split("::")[0]).stem for n in _slow_node_ids()}
    slow |= {p.stem for p in tests_dir.glob("test_*.py")
             if _marks_slow(ast.parse(p.read_text()))}
    assert not {s for s in slow if s.startswith("test_torch_")}, slow
    bad = slow & _port_importers(tests_dir)
    assert not bad, f"{sorted(bad)} carry slow and import the port"


def test_slow_names_only_tests_that_exist():
    """A node id in ``SLOW`` that names nothing would mark nothing, and the
    test it meant would stay in tier-1 unseen: every file, class and test
    it names is there."""
    for node_id in _slow_node_ids():
        path, *names = node_id.split("::")
        assert path.startswith("tests/test_"), node_id
        tree = ast.parse((ROOT / path).read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, (ast.ClassDef, ast.FunctionDef))}
        assert set(names) <= defined, node_id
