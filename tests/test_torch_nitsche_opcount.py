"""The host operation count of the Nitsche interface kernels K8/K9
(tigar_tpu_torch/csrc/nitsche_opcount.cpp), which chip_smoke.py builds to
bound them: it builds with the host compiler, its reverse-mode gradient,
flux Jacobian and Hessian agree with the kernels' forward-dual passes on
the same data, and its counts are ordered as the schemes they count."""

import json
import os
import subprocess

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tigar_tpu_torch", "csrc", "nitsche_opcount.cpp")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    exe = tmp_path_factory.mktemp("opcount") / "nitsche_opcount"
    subprocess.run([os.environ.get("CXX", "c++"), "-std=c++17", "-O1",
                    "-o", str(exe), SRC], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True)
    return out.returncode, json.loads(out.stdout.strip().splitlines()[-1])


def test_reverse_mode_matches_kernel_passes(report):
    """Gradient, flux Jacobian and Hessian of one side's flux pairing by
    reverse mode (and forward over reverse) against the kernels' one- and
    two-coefficient dual passes: 1e-12 / 1e-11."""
    rc, rep = report
    assert rc == 0 and rep["ok"] is True
    err = rep["rel_err"]
    assert err["grad"] <= 1e-12 and err["jacobian"] <= 1e-12
    assert err["hessian"] <= 1e-11


def test_counts_follow_the_schemes(report):
    """The primal flux pass is the cheapest; the reverse-mode gradient
    costs at most 4x it (the cheap-gradient bound for these operations)
    and less than the 27 first-order passes it replaces; the Hessian by
    forward over reverse costs less than the 378 second-order passes."""
    _, rep = report
    n = rep["per_side"]
    assert 0 < n["geom"] < n["primal"] < n["grad"] <= 4 * n["primal"]
    assert n["primal"] < n["pass1"] < n["pass2"]
    assert n["grad"] < 27 * n["pass1"]
    assert 27 * n["pass1"] < n["hess"] < 378 * n["pass2"]
