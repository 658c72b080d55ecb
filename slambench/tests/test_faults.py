"""A run whose timed path is broken underneath comes out not correct:
once for each fault the cells can have (a step that returns its state
unchanged, half of the batch left out with the mean over the rest, an
answer altered where it is produced). The run skips the look for a chip
and drives everything else of a run, on the CPU at a small size, against
the limits the cells are held to."""

import pytest
import torch

from slambench.tests import tiny


def _track_unchanged(slam):
    step = slam._track_step

    def broken(params, c2w_init, rays, generator=None, align=None):
        out = step(params, c2w_init, rays, generator, align)
        return (c2w_init.clone(),) + tuple(out[1:])

    slam._track_step = broken


class _UnchangedBA:
    """The loop's BA call, with the map and the poses put back as they
    were before it (its loss hook passes through to the real call's)."""

    def __init__(self, inner):
        self.__dict__["inner"] = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        setattr(self.inner, name, value)

    def __call__(self, params, kf_db, kf_poses, cur_pose, cur_rays,
                 generator, kf_aligns=None, cur_align=None):
        before = [t.detach().clone() for t in _leaves(params)]
        out = self.inner(params, kf_db, kf_poses, cur_pose, cur_rays,
                         generator, kf_aligns, cur_align)
        with torch.no_grad():
            for t, b in zip(_leaves(params), before):
                t.copy_(b)
        return (kf_poses, cur_pose) + tuple(out[2:])


def _ba_unchanged(slam):
    slam._ba = _UnchangedBA(slam._ba)


def _half_batch(slam):
    step = slam._track_step

    def broken(params, c2w_init, rays, generator=None, align=None):
        return step(params, c2w_init, rays[: rays.shape[0] // 2], generator,
                    align)

    slam._track_step = broken


def _encode_altered(slam):
    from coslam_torch.ops import hash_packed as HP

    fwd = HP.grid_encode_fwd_ref

    def altered(spec, table, x):
        return fwd(spec, table, x) + 1e-3

    HP.grid_encode_fwd_ref = altered


def _leaves(params):
    return [params["grid"], *params["decoder"]["sdf_net"],
            *params["decoder"]["color_net"]]


@pytest.fixture
def restore_encode():
    from coslam_torch.ops import hash_packed as HP

    saved = HP.grid_encode_fwd_ref
    yield
    HP.grid_encode_fwd_ref = saved


def test_sound_run_is_correct():
    r = tiny.run("replica_room0")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault,expect", [
    (_track_unchanged, "track_pose"),
    (_ba_unchanged, "ba_change"),
    (_half_batch, "track_loss0"),
    (_encode_altered, "query"),
])
def test_fault_comes_out_not_correct(fault, expect, restore_encode):
    r = tiny.run("replica_room0", hook=fault)
    assert not r["correct"]
    c = r["checks"][expect]
    assert not c["value"] <= c["limit"], r["checks"]
