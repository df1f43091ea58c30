"""The port's five examples (``repro_torch.examples``) at their tiny
defaults with ``--device cpu``: each runs to its end; ``train_lm``
resumes at the committed step; ``serve_lm``'s streams equal the port's
engine's on the same weights and prompts; ``user_collectives`` holds
every schedule to the native sum (f32, 1e-5: eight addends reordered);
and without ``--device`` each refuses to run on a host with no card."""
import numpy as np
import pytest
import torch

from repro_torch.examples import (progress_engine_tour, quickstart, serve_lm,
                                  train_lm, user_collectives)


def test_quickstart_trains_and_the_loss_falls(capsys):
    log = quickstart.main(["--device", "cpu"])
    assert log[-1]["loss"] < log[0]["loss"]
    assert "quickstart OK" in capsys.readouterr().out


def test_train_lm_resumes_at_the_committed_step(tmp_path):
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = train_lm.main(argv + ["--steps", "6"])
    assert first["resumed_from"] is None and first["start_step"] == 0
    assert [m["step"] for m in first["log"]] == [0, 5]
    second = train_lm.main(argv + ["--steps", "8"])
    # the Trainer commits the last step of a run: step 5
    assert second["resumed_from"] == 5 and second["start_step"] == 6
    assert [m["step"] for m in second["log"]] == [7]
    # the restored state is the first run's last
    restored = second["trainer"].ckpt.restore(5, {
        "params": first["trainer"].params,
        "opt_state": first["trainer"].opt_state})
    assert torch.equal(restored["params"]["embed"],
                       first["trainer"].params["embed"])
    third = train_lm.main(argv + ["--steps", "8"])
    assert third["resumed_from"] == 7 and third["log"] == []


def test_serve_lm_streams_equal_the_engine(capsys):
    from repro_torch.core import ProgressEngine
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine
    got = serve_lm.main(["--device", "cpu", "--requests", "4",
                         "--slots", "2", "--max-new", "5"])
    cfg = serve_lm.tiny_config()
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=2,
                      max_seq=64, device="cpu")
    reqs = [GenRequest(f"r{i}", p, max_new_tokens=5)
            for i, p in enumerate(serve_lm.prompts(4))]
    for r in reqs:
        srv.submit(r)
    srv.run_until_idle(timeout=300)
    srv.close()
    assert got == [list(r.out_tokens) for r in reqs]
    assert all(len(s) == 5 for s in got)
    assert "continuous batching factor" in capsys.readouterr().out


def test_user_collectives_hold_to_the_native_sum():
    out = user_collectives.main(["--device", "cpu"])
    assert set(out["errors"]) >= {"ring", "bidir", "recursive_doubling",
                                  "halving_doubling",
                                  "persistent ring chunks=4",
                                  "collective_matmul_ag"}
    assert max(out["errors"].values()) <= 1e-5, out["errors"]
    assert set(out["fig13_us"]) == {"native", "ring", "bidir",
                                    "recursive_doubling", "halving_doubling"}
    assert all(np.isfinite(v) and v > 0 for v in out["fig13_us"].values())


def test_progress_engine_tour_runs_to_its_end(capsys):
    progress_engine_tour.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("1.7 generalized request", "nonblocking collectives",
                 "serve collectives", "fault tolerance", "1F1B pipeline",
                 "fsdp:", "PL001 caught: `synchronize`", "tour OK"):
        assert line in out, line


@pytest.mark.parametrize("example", [quickstart, serve_lm, train_lm,
                                     user_collectives, progress_engine_tour])
def test_an_example_without_device_needs_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])
