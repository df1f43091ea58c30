"""Data-parallel, FSDP and elastic training of the MoE family
(granite-moe-3b-a800m: each rank routes its own share of the batch, in
both launchers) against the JAX launcher and against the port's own
forms, at the tiny scale in f32, 2 ranks, 2 steps
(``tests/_torch_families.py``): ``--devices 2 --collective-backend
user`` within 1e-5 of the JAX launcher's losses; ``--rank-devices
cpu,cpu`` bit for bit the rank-stacked run; ``--fsdp`` on the user and
native backends and with ``--rank-devices``, bit for bit each other
(losses and checkpoint files), within the f32 limits of the
data-parallel run; ``--chaos-kill 1`` bit for bit a checkpoint and a
restart on the survivor."""
import pytest

from tests import _torch_families as F

ARCHS = ('granite-moe-3b-a800m',)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return F.jax_launcher_runs(tmp_path_factory.mktemp("families"), ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_matches_the_jax_launcher(ref, tmp_path, arch):
    F.check_dp_matches_the_jax_launcher(ref, tmp_path, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_devices_equal_the_stacked_run(ref, tmp_path, arch):
    F.check_rank_devices_equal_the_stacked_run(ref, tmp_path, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_user_equals_native_and_holds_data_parallel(ref, tmp_path,
                                                         arch):
    F.check_fsdp_user_equals_native(ref, tmp_path, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_chaos_kill_equals_a_restart(ref, tmp_path, arch, monkeypatch):
    F.check_chaos_kill_equals_a_restart(ref, tmp_path, arch, monkeypatch)
