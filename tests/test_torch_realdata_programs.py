"""The real-data programs, port vs JAX package, over one data directory.

The reference's data files are not in the repository, so the test writes
files from seeds in the reference's formats into a temporary directory: a
201-point curve (``models/realdata.synthetic_curve``) and a 401-point
quintic (``synthetic_quintic`` with its outliers kept under 10^3, as
``tests/test_torch_realdata.py`` keeps them: the JAX package's GNC compiles
once per outer round) as ``x,y`` files with one header line, and a BAL
problem of 7 cameras, 200 points and 850 observations (``synthetic_bal``)
under the reference's name ``problem-49-7776-pre.txt``. The JAX programs
read it through their module's ``REF_DATA``, set for the test; the port's
through its command line (``--data-dir``, ``--device cpu``), which writes
``results_torch/realdata/summary.json`` under the working directory. Every
summary field is compared: the field names (the port adds ``device``);
fitted parameters and their errors to 1e-3 (the tolerance of
``tests/test_torch_realdata.py``); BAL's sizes and LM iterations equal, its
initial cost to 1e-5 relative, its final costs to 1e-3 relative, and both
sharded assemblies within 1e-5 of their dense ones (the JAX package's on 4
of the 8 virtual devices, the port's on the stacked 8-shard mesh). A
missing file raises ``FileNotFoundError`` naming it, and the data directory
has no default.
"""

import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from mloam_tpu.models import realdata as JRD
from mloam_tpu_torch.models import realdata as RD
from mloam_tpu_torch.solver import bal as BAL

TOL = 1e-3
PROGRAMS = ("curve", "nonconvex", "bal")


def write_data(d):
    RD.write_xy(str(d / RD.CURVE_FILE), *RD.synthetic_curve(0))
    x, y = RD.synthetic_quintic(0)
    rng = np.random.default_rng(11)
    truth = np.polyval(RD.QUINTIC_GT, x)
    big = np.abs(y - truth) > 5
    y[big] = truth[big] + np.sign(y[big] - truth[big]) * 10.0 ** rng.uniform(1, 3, big.sum())
    RD.write_xy(str(d / RD.NONCONVEX_FILE), x, y)
    (cams, pts, ci, pi, obs), _ = RD.synthetic_bal(1, n_cams=7, n_pts=200, n_obs=850)
    BAL.write_bal(str(d / RD.BAL_FILE), cams, pts, ci, pi, obs)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_data(d)
    return d


@pytest.fixture(scope="module")
def jax_res(data_dir):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JRD, "REF_DATA", str(data_dir))
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("obs",))
        return {"curve": JRD.curve_program(), "nonconvex": JRD.nonconvex_program(),
                "bal": JRD.bal_program(mesh)}


@pytest.fixture(scope="module")
def port_run(data_dir, tmp_path_factory):
    work = tmp_path_factory.mktemp("work")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        res = RD.main(["all", "--data-dir", str(data_dir), "--device", "cpu"])
    return res, work / "results_torch" / "realdata" / "summary.json"


@pytest.mark.parametrize("program", PROGRAMS)
def test_summary_has_the_jax_fields(jax_res, port_run, program):
    got, want = port_run[0][program], jax_res[program]
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    if program != "bal":
        assert got["n"] == want["n"] and tuple(got["gt"]) == tuple(want["gt"])
        assert set(got["fits"]) == set(want["fits"]) == {"trivial", "huber", "gm", "gnc_gm"}
        for loss in got["fits"]:
            assert set(got["fits"][loss]) == set(want["fits"][loss])


@pytest.mark.parametrize("loss", ["trivial", "huber", "gm", "gnc_gm"])
def test_curve_fits_match(jax_res, port_run, loss):
    got, want = port_run[0]["curve"]["fits"][loss], jax_res["curve"]["fits"][loss]
    for k in ("m", "c", "param_err"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=TOL), k


@pytest.mark.parametrize("loss", ["trivial", "huber", "gm", "gnc_gm"])
def test_quintic_fits_match(jax_res, port_run, loss):
    got, want = port_run[0]["nonconvex"]["fits"][loss], jax_res["nonconvex"]["fits"][loss]
    np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=0, atol=TOL)
    assert got["max_coeff_err"] == pytest.approx(want["max_coeff_err"], rel=0, abs=TOL)
    if loss != "trivial":
        assert got["max_coeff_err"] < 0.3


def test_bal_matches(jax_res, port_run):
    got, want = port_run[0]["bal"], jax_res["bal"]
    assert (got["cams"], got["pts"], got["obs"]) == (want["cams"], want["pts"], want["obs"])
    assert (got["cams"], got["pts"], got["obs"]) == (7, 200, 850)
    assert got["lm_iters"] == want["lm_iters"] == RD.BAL_ITERS
    assert got["initial_cost"] == pytest.approx(want["initial_cost"], rel=1e-5)
    for k in ("final_cost", "huber_final_cost"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert got["final_cost"] < 0.01 * got["initial_cost"]
    assert len(got["sharded_assembly_rel_err"]) == len(want["sharded_assembly_rel_err"]) == 5
    assert max(got["sharded_assembly_rel_err"]) <= 1e-5
    assert max(want["sharded_assembly_rel_err"]) <= 1e-5
    assert got["wall_s"] > 0


def test_command_line_writes_the_summary(port_run):
    res, path = port_run
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    assert set(res) == set(PROGRAMS)


@pytest.mark.parametrize("program,name", [("curve", RD.CURVE_FILE),
                                          ("nonconvex", RD.NONCONVEX_FILE),
                                          ("bal", RD.BAL_FILE)])
def test_a_missing_file_raises_naming_it(tmp_path, program, name):
    fn = getattr(RD, f"{program}_program")
    with pytest.raises(FileNotFoundError, match=name.replace(".", r"\.")):
        fn(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match=name.replace(".", r"\.")):
        RD.main([program, "--data-dir", str(tmp_path), "--device", "cpu"])


def test_the_data_directory_has_no_default(capsys):
    with pytest.raises(SystemExit):
        RD.main(["curve", "--device", "cpu"])
    assert "--data-dir" in capsys.readouterr().err
