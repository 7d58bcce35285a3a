"""Grid-search sweep: runs, records results, resumes by skipping."""

import argparse
import json
import os

import numpy as np
import pytest

# repo root on sys.path: tests/conftest.py bootstraps it for the session

import search as search_mod  # noqa: E402
from calciumgan.data import segments  # noqa: E402


@pytest.fixture
def dataset_dir(tmp_path, rng):
    data = {"signals": rng.random((4, 700)).astype(np.float32),
            "oasis": (rng.random((4, 700)) < 0.05).astype(np.float32)}
    signals, spikes, meta = segments.preprocess(
        data, 32, 8, do_normalize=True, is_dg_data=True)
    out = str(tmp_path / "records")
    segments.write_dataset(out, signals, spikes, meta, 32, 8,
                           validation_size=8, do_normalize=True,
                           apply_fft=False, conv2d=False, verbose=0)
    return out


def test_search_runs_and_resumes(tmp_path, dataset_dir, monkeypatch, capsys):
    monkeypatch.setattr(search_mod, "DEFAULT_GRID", {
        "algorithm": ["wgan-gp"], "model": ["mlp"],
        "activation": ["leakyrelu"], "noise_dim": [4, 8], "num_units": [4],
        "kernel_size": [2], "strides": [1], "phase_shuffle": [0],
        "gradient_penalty": [10.0], "n_critic": [1],
    })
    args = argparse.Namespace(
        input_dir=dataset_dir, output_dir=str(tmp_path / "sweep"),
        batch_size=8, epochs=1, clear_output_dir=False,
        mixed_precision=False, verbose=0)
    search_mod.search(args)

    results_path = os.path.join(args.output_dir, "results.jsonl")
    with open(results_path) as f:
        lines = [json.loads(l) for l in f]
    assert [l["session"] for l in lines] == [1, 2]
    assert all("signals_metrics/min" in l["metrics"] for l in lines)
    assert {l["params"]["noise_dim"] for l in lines} == {4, 8}

    # resume: both experiments skipped, results file unchanged
    search_mod.search(args)
    out = capsys.readouterr().out
    assert out.count("already exists") == 2
    with open(results_path) as f:
        assert len(f.readlines()) == 2


def test_search_survives_experiment_failure(tmp_path, dataset_dir,
                                            monkeypatch, capsys):
    monkeypatch.setattr(search_mod, "DEFAULT_GRID", {
        "algorithm": ["wgan-gp"], "model": ["mlp", "bogus-model"],
        "activation": ["leakyrelu"], "noise_dim": [4], "num_units": [4],
        "kernel_size": [2], "strides": [1], "phase_shuffle": [0],
        "gradient_penalty": [10.0], "n_critic": [1],
    })
    args = argparse.Namespace(
        input_dir=dataset_dir, output_dir=str(tmp_path / "sweep2"),
        batch_size=8, epochs=1, clear_output_dir=False,
        mixed_precision=False, verbose=0)
    search_mod.search(args)   # must not raise
    out = capsys.readouterr().out
    assert "ERROR" in out
    with open(os.path.join(args.output_dir, "results.jsonl")) as f:
        assert len(f.readlines()) == 1  # only the valid model recorded

def test_search_parallel_over_device_slices(tmp_path, dataset_dir,
                                            monkeypatch):
    """Two experiments run concurrently, each on a 4-device slice of the
    faked 8-device mesh."""
    monkeypatch.setattr(search_mod, "DEFAULT_GRID", {
        "algorithm": ["wgan-gp"], "model": ["mlp"],
        "activation": ["leakyrelu"], "noise_dim": [4, 8], "num_units": [4],
        "kernel_size": [2], "strides": [1], "phase_shuffle": [0],
        "gradient_penalty": [10.0], "n_critic": [1],
    })
    args = argparse.Namespace(
        input_dir=dataset_dir, output_dir=str(tmp_path / "psweep"),
        batch_size=8, epochs=1, clear_output_dir=False,
        mixed_precision=False, parallel=2, verbose=0)
    search_mod.search(args)
    with open(os.path.join(args.output_dir, "results.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    assert sorted(l["session"] for l in lines) == [1, 2]
    assert all(np.isfinite(list(l["metrics"].values())).all() for l in lines)


def test_summarize_ranks_by_metric(tmp_path, capsys):
    out = str(tmp_path / "sweepz")
    os.makedirs(out)
    with open(os.path.join(out, "results.jsonl"), "w") as f:
        f.write(json.dumps({"session": 1, "params": {"noise_dim": 4},
                            "metrics": {"signals_metrics/mean": 0.9}}) + "\n")
        f.write(json.dumps({"session": 2, "params": {"noise_dim": 8},
                            "metrics": {"signals_metrics/mean": 0.1}}) + "\n")
    rows = search_mod.summarize(out)
    assert [r["session"] for r in rows] == [2, 1]
    text = capsys.readouterr().out
    assert text.index("      2") < text.index("      1")


def test_search_grid_override(tmp_path, dataset_dir, monkeypatch):
    """--grid replaces listed DEFAULT_GRID entries (unlisted keep defaults)
    and rejects unknown keys."""
    monkeypatch.setattr(search_mod, "DEFAULT_GRID", {
        "algorithm": ["wgan-gp"], "model": ["mlp"],
        "activation": ["leakyrelu"], "noise_dim": [4, 8, 16],
        "num_units": [4], "kernel_size": [2], "strides": [1],
        "phase_shuffle": [0], "gradient_penalty": [10.0], "n_critic": [1],
    })
    args = argparse.Namespace(
        input_dir=dataset_dir, output_dir=str(tmp_path / "sweep"),
        batch_size=8, epochs=1, clear_output_dir=False,
        mixed_precision=False, verbose=0,
        grid=json.dumps({"noise_dim": [4]}))
    search_mod.search(args)
    with open(os.path.join(args.output_dir, "results.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    assert len(lines) == 1 and lines[0]["params"]["noise_dim"] == 4

    args.grid = json.dumps({"bogus_key": [1]})
    args.output_dir = str(tmp_path / "sweep2")
    with pytest.raises(ValueError, match="bogus_key"):
        search_mod.search(args)
