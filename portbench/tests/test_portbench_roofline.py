"""The fluid step core's least bytes, as the port's kernel table records
them at the main path's shapes."""

import pytest

from portbench.harness.roofline import HBM_BYTES_PER_S, fluid_step_bound_s, fluid_step_work


@pytest.mark.parametrize("shape, nbytes", [
    ((8, 160, 16, 16, False), 129_920),  # paper, 8 lanes
    ((8, 48, 8, 8, True), 42_176),  # model_zoo with the overlap plane
    ((8, 160, 16, 16, True), 334_720),  # paper with the plane (k-way)
])
def test_bytes_at_the_main_path_shapes(shape, nbytes):
    assert fluid_step_work(*shape)[0] == nbytes
    # these shapes are bound by bytes, not operations
    assert fluid_step_bound_s(*shape) == pytest.approx(nbytes / HBM_BYTES_PER_S)


def test_the_plane_adds_its_product():
    _, ops = fluid_step_work(8, 48, 8, 8, False)
    _, ops_plane = fluid_step_work(8, 48, 8, 8, True)
    assert ops_plane - ops == 2 * 8 * 48 * 48 * 8
