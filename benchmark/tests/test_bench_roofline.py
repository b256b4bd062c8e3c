"""The frozen operation count equals the port's ``joint_ll_flops`` at
both configurations (the count the benchmark froze), and the byte count
covers each input of the model once."""

import pytest

from benchmark import roofline
from benchmark.reference.model.build import build_model
from benchmark.tests.conftest import CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_flops_equal_the_ports_count(datasets, name):
    from joxsz_torch.build import build_session
    from joxsz_torch.config import JoXSZConfig
    from joxsz_torch.ops.joint_kernel import (joint_ll_bytes,
                                              joint_ll_flops, pack_consts)

    cfg_path = datasets[name][0]
    shapes = roofline.model_shapes(build_model(cfg_path))
    consts = pack_consts(build_session(
        JoXSZConfig.from_json(cfg_path.read_text()), device="cpu"))
    assert roofline.flops_per_eval(shapes) == joint_ll_flops(consts)
    assert shapes["D"] == consts.ints["D"]
    assert shapes["n_sh"] == consts.ints["n_sh"]
    # the program's buffer holds derived arrays beside the inputs (log
    # radii, knot tables, the veto's split radii): more than the inputs
    inputs = roofline.const_bytes(shapes)
    assert inputs < joint_ll_bytes(consts, 0) < 3 * inputs


def test_least_time_charges_the_projection_at_the_tensor_rate():
    s = {"n_press": 313, "n_pix": 86, "n_data": 19, "sep": 85, "n_sh": 15,
         "n_ann": 15, "n_band": 10, "nT": 64, "n_conv": 41, "D": 13,
         "knots": 0, "t_vikh": False, "double": False, "mass_veto": True}
    proj, rest = roofline.flops_split(s)
    assert proj == 2 * 313 * 86
    t = roofline.eval_seconds(s)
    assert t == pytest.approx(proj / 495e12 + rest / 67e12)
    # an evaluation all on the float32 units would take longer than the
    # least time: no kernel can read over 100%
    assert (proj + rest) / 67e12 > t
    assert roofline.launch_least_seconds(s, 4096 * 100, 4096) \
        == pytest.approx(4096 * 100 * t)
