"""The control, at a size a test run holds: the reference in the
precision below the configuration's (TF32 matrix products on the card,
a bfloat16 hash encode on both) put in the program's place fails the
limits that the program's own run keeps."""

import pytest

from slambench.tests import tiny


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_control_fails_where_the_program_passes(request, device):
    if device == "cuda":
        device = str(request.getfixturevalue("cuda_device"))
    r = tiny.run("replica_room0", device=device, control=True)
    assert r["correct"], r["checks"]
    limits = {k: v["limit"] for k, v in r["checks"].items()}
    assert any(not r["control"][k] <= lim for k, lim in limits.items()), (
        r["control"], limits)
