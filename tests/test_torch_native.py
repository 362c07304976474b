"""The placement path's host libraries (``rappas_tpu_torch/native/``) are
required, with no Python fallback: a library that cannot be built raises
one :class:`NativeUnavailable` from ``native.load`` that names its source
and the compiler's message, and ``place_queries`` raises it before it
writes a jplace."""

import subprocess

import numpy as np
import pytest

from rappas_tpu_torch import native
from rappas_tpu_torch.place.pipeline import PlacementConfig, place_queries
from test_torch_imports import _tiny_db


def _reads(path, n=20, length=60):
    rng = np.random.default_rng(1)
    path.write_text("".join(
        f">r{i} x\n{''.join(rng.choice(list('ACGT'), length))}\n"
        for i in range(n)))
    return path


def _place(tmp_path, table):
    return place_queries(_tiny_db(), _reads(tmp_path / "q.fasta"),
                         tmp_path / "wd",
                         PlacementConfig(device="cpu", table=table,
                                         batch_size=8))


def test_place_queries_runs_on_every_native_library(tmp_path, monkeypatch):
    loaded = set()
    load = native.load

    def spy(name):
        loaded.add(name)
        return load(name)
    monkeypatch.setattr(native, "load", spy)
    out = _place(tmp_path, "postings")
    assert out.exists()
    assert loaded == {"ingest", "jplacefmt", "keyprobe"}


@pytest.mark.parametrize("lib, table", [("ingest", "compact"),
                                        ("jplacefmt", "compact"),
                                        ("keyprobe", "postings")])
def test_place_queries_raises_without_a_native_library(tmp_path, monkeypatch,
                                                       lib, table):
    load = native.load

    def broken(name):
        if name == lib:
            raise native.NativeUnavailable(f"could not build {name}.cpp")
        return load(name)
    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(native.NativeUnavailable, match=lib):
        _place(tmp_path, table)
    assert not (tmp_path / "wd" / "placements_q.fasta.jplace").exists()


def test_native_load_names_the_library_and_the_compiler(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "_LIBS", {})

    def no_compiler(cmd, **kwargs):
        raise FileNotFoundError(2, "No such file or directory", "g++")
    monkeypatch.setattr(subprocess, "run", no_compiler)
    with pytest.raises(native.NativeUnavailable,
                       match=r"ingest\.cpp: g\+\+ is required"):
        native.load("ingest")

    def compile_error(cmd, **kwargs):
        raise subprocess.CalledProcessError(
            1, cmd, stderr=b"ingest.cpp:1:1: error: boom")
    monkeypatch.setattr(subprocess, "run", compile_error)
    with pytest.raises(native.NativeUnavailable,
                       match=r"ingest\.cpp with g\+\+: .*error: boom"):
        native.load("ingest")
    assert native._LIBS == {}
