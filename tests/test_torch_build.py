"""``-p b`` in the port: the DB build (``rappas_tpu_torch.build``,
``ar``, ``extend``, ``alignment``, ``models`` and the native explorer)
against the JAX package's, on the canned RAxML-ng ``--ardir`` fixture
(no AR binary is needed) and on ``chip_smoke.synthetic_ardir``'s inputs.

A port DB must equal the JAX DB bitwise (keys, offsets, edges, the
deltas' bits), its header (k, omega, states, threshold bits, tree) and
its ``meta`` equal except ``build_seconds``; the written artifacts are
byte-identical.  Calibration (``rappas_tpu_torch.build.calibration``,
the engine on the CPU) must give JAX's bound within 2e-4, and ``-p b
--dbinram -q`` placements JAX's within the engine tolerances of
``tests/test_engine.py:41-60``."""

import json
import shutil

import numpy as np
import pytest

import chip_smoke
from rappas_tpu.ar.launcher import ARLauncher as JaxLauncher
from rappas_tpu.build import calibration as jax_calibration
from rappas_tpu.build import explorer as jax_explorer
from rappas_tpu.build.pipeline import BuildConfig as JaxConfig
from rappas_tpu.build.pipeline import build_database as jax_build
from rappas_tpu.cli import main as jax_main
from rappas_tpu.models import EvolModel as JaxModel
from rappas_tpu.native import explore_node_exact_native as jax_native
from rappas_tpu_torch.ar.launcher import ARLauncher
from rappas_tpu_torch.build import calibration
from rappas_tpu_torch.build import explorer
from rappas_tpu_torch.build.pipeline import BuildConfig, build_database
from rappas_tpu_torch.cli import main as port_main
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.models import EvolModel
from rappas_tpu_torch.native import explore_node_exact_native
from rappas_tpu_torch.tree import write_newick
from test_engine import synthetic_db
from test_torch_e2e import _same_outputs
from test_torch_engine import port_db

AR_FILES = ("extended_align.phylip.raxml.ancestralProbs",
            "extended_align.phylip.raxml.ancestralTree",
            "extended_align.phylip.raxml.log")


def _ardir(fixtures_dir, dest):
    """A copy of the canned AR outputs (a build writes its
    ``ARtree_id_mapping.tsv`` into the AR directory)."""
    dest.mkdir(parents=True)
    for name in AR_FILES:
        shutil.copy(fixtures_dir / "raxmlng_ardir" / name, dest)
    return dest


def same_db(p, j):
    """Port DB ``p`` equals JAX DB ``j``: arrays bitwise, header, meta
    except ``build_seconds``."""
    for key in ("keys", "offsets", "edges", "deltas"):
        a, b = getattr(p, key), getattr(j, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), key
    assert (p.k, p.omega, p.alphabet.name) == (j.k, j.omega, j.alphabet.name)
    assert np.float32(p.thr_log10).view(np.uint32) == \
        np.float32(j.thr_log10).view(np.uint32)
    assert write_newick(p.tree, True, True, True, False) == \
        write_newick(j.tree, True, True, True, False)
    pm, jm = dict(p.meta), dict(j.meta)
    assert pm.pop("build_seconds") >= 0 and jm.pop("build_seconds") >= 0
    assert pm == jm


def _artifacts(wd, ar_dir):
    files = sorted((wd / "extended_trees").iterdir())
    out = {f.name: f.read_bytes() for f in files}
    for f in (wd / "align.reduced", ar_dir / "ARtree_id_mapping.tsv"):
        if f.exists():
            out[f.name] = f.read_bytes()
    return out


def _both(fixtures_dir, tmp_path, align=None, tree=None, ar=None, **kw):
    """The same build through both packages, each with its own copy of
    the AR outputs; returns (port DB, JAX DB, port wd, JAX wd)."""
    align = align or fixtures_dir / "tiny.fasta"
    tree = tree or fixtures_dir / "tiny.tree"
    out = []
    for name, cfg_cls, build in (("port", BuildConfig, build_database),
                                 ("jax", JaxConfig, jax_build)):
        if ar is None:
            ar_dir = _ardir(fixtures_dir, tmp_path / f"{name}_ar")
        else:
            ar_dir = tmp_path / f"{name}_ar"
            shutil.copytree(ar, ar_dir)
        cfg = cfg_cls(ar_binary="/fake/path/raxml-ng", ar_dir=str(ar_dir),
                      **kw)
        wd = tmp_path / name
        out.append((build(align, tree, wd, cfg), wd, ar_dir))
    (p, pwd, par), (j, jwd, jar) = out
    assert _artifacts(pwd, par) == _artifacts(jwd, jar)
    return p, j, pwd, jwd


# ------------------------------------------------------------------ #
# the canned fixture

def test_cli_build_equals_expected_and_jax(tmp_path, fixtures_dir):
    """``python -m rappas_tpu_torch.cli -p b --ardir`` builds the DB the
    fixture was made for, bit for bit, and the same DB, artifacts and
    meta as the JAX CLI."""
    exp = np.load(fixtures_dir / "raxmlng_ardir" / "expected_db.npz")
    dbs, arts = [], []
    for name, main in (("port", port_main), ("jax", jax_main)):
        ar = _ardir(fixtures_dir, tmp_path / f"{name}_ar")
        wd = tmp_path / name
        assert main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                     "-t", str(fixtures_dir / "tiny.tree"),
                     "-b", "/fake/raxml-ng", "--ardir", str(ar),
                     "-w", str(wd)]) == 0
        dbs.append(PhyloKmerDB.load(wd / "DB_k8_o1.5.rptpu"))
        arts.append(_artifacts(wd, ar))
    for key in ("keys", "offsets", "edges", "deltas"):
        assert np.array_equal(getattr(dbs[0], key).view(np.uint8),
                              exp[key].view(np.uint8)), key
    same_db(*dbs)
    assert arts[0] == arts[1]
    assert arts[0]["ARtree_id_mapping.tsv"] == (
        fixtures_dir / "raxmlng_ardir" / "ARtree_id_mapping.tsv").read_bytes()
    assert dbs[0].meta["ar_program"] == "raxml-ng"
    assert dbs[0].meta["model"] == "GTR"


@pytest.mark.parametrize("kw", [
    {"do_gap_jumps": True},                              # --force-gap-jump
    {"do_gap_jumps": True, "limit_to_1_jump": False},    # --do-n-jumps
    {"exact_explorer": True},
    {"only_fake_nodes": False},                          # --original-nodes
    {"only_x1_nodes": True},                             # --onlyX1
    {"reduction": False},                                # --no-reduction
    {"k": 6}, {"k": 10}, {"omega": 1.0}, {"omega": 2.0},
    {"gap_jump_threshold": 0.0},                      # gap jumps by ratio
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_build_variants_equal_jax(tmp_path, fixtures_dir, kw):
    p, j, _, _ = _both(fixtures_dir, tmp_path, **kw)
    same_db(p, j)
    assert p.nnz > 0
    if kw.get("do_gap_jumps") or "gap_jump_threshold" in kw:
        assert p.meta["gap_jumps"]
    if "only_fake_nodes" in kw:
        assert p.meta["orinodes_resolution"]


@pytest.mark.parametrize("states, n_taxa, n_sites, k", [
    ("nucl", 12, 300, 8), ("amino", 8, 120, 4)])
def test_synthetic_ardir_build_equals_jax(tmp_path, states, n_taxa, n_sites,
                                          k):
    """``chip_smoke.synthetic_ardir``'s inputs (an unrooted AR tree that
    the parser re-roots) build the same DB in both packages."""
    align, tree, ar = chip_smoke.synthetic_ardir(tmp_path / "syn", n_taxa,
                                                 n_sites, seed=3,
                                                 states=states)
    p, j, _, _ = _both(None, tmp_path, align=align, tree=tree, ar=ar, k=k,
                       states=states)
    same_db(p, j)
    assert p.meta["ar_program"] == "raxml-ng" and p.nnz > 0
    # every branch of the original tree carries postings
    assert len(set(p.edges.tolist())) == 2 * n_taxa - 2


# ------------------------------------------------------------------ #
# the explorers

def _posteriors(seed, L, S):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(S, 0.3), L).astype(np.float32)
    return np.log10(np.maximum(p, np.float32(1e-30)), dtype=np.float32)


def _bits(codes_sums):
    codes, sums = codes_sums
    return codes.tolist(), sums.view(np.uint32).tolist()


@pytest.mark.parametrize("S, k", [(4, 5), (20, 3)])
@pytest.mark.parametrize("gaps", [None, "one_jump", "n_jumps"])
def test_explorers_equal_jax(S, k, gaps):
    """``explore_node``, ``explore_node_exact`` (the plain version),
    ``explore_node_exact_native`` and ``sort_probas_desc`` give JAX's
    output bit for bit, with and without gap intervals."""
    P = _posteriors(S * 10 + k, 30, S)
    thr = np.float32(np.log10((1.5 / S) ** k))
    st, pp = explorer.sort_probas_desc(P)
    jst, jpp = jax_explorer.sort_probas_desc(P)
    assert np.array_equal(st, jst) and np.array_equal(
        pp.view(np.uint32), jpp.view(np.uint32))
    if gaps is None:
        got = explorer.explore_node(P, k, thr)
        assert got[0].size > 0
        assert _bits(got) == _bits(jax_explorer.explore_node(P, k, thr))
        kw = {}
    else:
        kw = {"gap_intervals": {2: [1], 7: [3, 1], 12: [2], 20: [4]},
              "do_gap_jumps": True,
              "limit_to_1_jump": gaps == "one_jump"}
    plain = explorer.explore_node_exact(st, pp, k, thr, **kw)
    native = explore_node_exact_native(st, pp, k, thr, **kw)
    assert plain[0].size > 0
    assert _bits(native) == _bits(plain)
    assert _bits(plain) == _bits(jax_explorer.explore_node_exact(
        jst, jpp, k, thr, **kw))
    assert _bits(native) == _bits(jax_native(jst, jpp, k, thr, **kw))


def test_native_explorer_fails_loudly(tmp_path, fixtures_dir, monkeypatch):
    """No fallback to the Python recursion: a gap-jump build whose native
    explorer cannot be built raises."""
    from rappas_tpu_torch import native
    from rappas_tpu_torch.build import pipeline

    def broken():
        raise native.NativeUnavailable("could not build wordexplorer")

    monkeypatch.setattr(pipeline, "_we_lib", broken)
    cfg = BuildConfig(ar_binary="/fake/raxml-ng", do_gap_jumps=True,
                      ar_dir=str(_ardir(fixtures_dir, tmp_path / "ar")))
    with pytest.raises(native.NativeUnavailable):
        build_database(fixtures_dir / "tiny.fasta",
                       fixtures_dir / "tiny.tree", tmp_path / "wd", cfg)


# ------------------------------------------------------------------ #
# AR inputs

@pytest.mark.parametrize("binary, states, model", [
    ("phyml", "nucl", None), ("phyml", "amino", "WAG"),
    ("raxml-ng", "nucl", "HKY85"), ("raxml-ng", "amino", None),
    ("baseml", "nucl", None), ("codeml", "amino", "JTT")])
def test_arinputonly_command_equals_jax(tmp_path, fixtures_dir, binary,
                                        states, model):
    """``--arinputonly``: exit 0, no DB, and the AR command line JAX
    writes (paths normalised)."""
    stem = "tiny_aa" if states == "amino" else "tiny"
    texts = []
    for name, main in (("port", port_main), ("jax", jax_main)):
        wd = tmp_path / name
        args = ["-p", "b", "-r", str(fixtures_dir / f"{stem}.fasta"),
                "-t", str(fixtures_dir / f"{stem}.tree"), "-s", states,
                "-b", f"/fake/bin/{binary}", "-w", str(wd), "--arinputonly"]
        assert main(args + (["-m", model] if model else [])) == 0
        assert not list(wd.glob("*.rptpu"))
        texts.append((wd / "AR" / "ar_command.txt").read_text()
                     .replace(str(wd), "WD"))
    assert texts[0] == texts[1] and texts[0].startswith(f"/fake/bin/{binary}")


@pytest.mark.parametrize("binary, model", [
    ("baseml", "GTR"), ("baseml", "K80"), ("codeml", "LG"),
    ("codeml", "DCMut"), ("codeml", "MtArt")])
def test_paml_ctl_equals_jax(tmp_path, binary, model):
    """The PAML control file equals JAX's, the rate matrix taken from the
    port's own copy of ``ar/paml_dat``."""
    texts = []
    for name, launcher, evol in (("port", ARLauncher, EvolModel),
                                 ("jax", JaxLauncher, JaxModel)):
        ar = tmp_path / name
        ar.mkdir()
        launch = launcher(f"/nonexistent/{binary}",
                          evol.from_string(model, 0.8, 6))
        ctl = launch.write_paml_ctl(ar, ar / "a.phylip", ar / "t.tree")
        text = ctl.read_text().replace(str(ar), "AR")
        texts.append(text)
        if binary == "codeml":
            dat = launch._find_paml_dat(launch.model.paml_equivalent)
            assert dat.parent.parent.parent.name == (
                "rappas_tpu_torch" if name == "port" else "rappas_tpu")
            texts[-1] = text.replace(str(dat.parent), "DAT")
    assert texts[0] == texts[1]
    assert launch.build_command(ar, ar / "a", ar / "t")[1].endswith("ar.ctl")


def test_aronly_stops_after_parse(tmp_path, fixtures_dir):
    """``--aronly``: exit 0, the AR outputs parsed (their id mapping
    written), no DB."""
    ar = _ardir(fixtures_dir, tmp_path / "ar")
    assert port_main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                      "-t", str(fixtures_dir / "tiny.tree"),
                      "-b", "/fake/raxml-ng", "--ardir", str(ar),
                      "-w", str(tmp_path / "wd"), "--aronly"]) == 0
    assert (ar / "ARtree_id_mapping.tsv").stat().st_size > 0
    assert not list((tmp_path / "wd").glob("*.rptpu"))


# ------------------------------------------------------------------ #
# --ardir checks (tests/test_ardir.py through the port)

def _port_build(fixtures_dir, workdir, ar_dir, align, tree):
    cfg = BuildConfig(k=8, omega=1.5, states="nucl",
                      ar_binary="/fake/path/raxml-ng", ar_dir=str(ar_dir))
    return build_database(align, tree, workdir, cfg)


def test_ardir_wrong_tree_aborts(tmp_path, fixtures_dir):
    recs = (fixtures_dir / "tiny.fasta").read_text().split(">")
    keep = [r for r in recs if r and not r.startswith("T6")]
    (tmp_path / "sub.fasta").write_text(">" + ">".join(keep))
    (tmp_path / "sub.tree").write_text(
        "(((T1:0.1,T2:0.12)n1:0.2,T3:0.3)n2:0.15,"
        "(T4:0.11,T5:0.09)n3:0.22)root;\n")
    with pytest.raises(SystemExit, match="does not match"):
        _port_build(fixtures_dir, tmp_path / "wd",
                    _ardir(fixtures_dir, tmp_path / "ar"),
                    tmp_path / "sub.fasta", tmp_path / "sub.tree")


def test_ardir_wrong_sites_aborts(tmp_path, fixtures_dir):
    out = []
    for block in (fixtures_dir / "tiny.fasta").read_text().split(">"):
        if not block.strip():
            continue
        name, seq = block.split("\n", 1)
        out.append(f">{name}\n{seq.strip()[:100]}\n")
    (tmp_path / "short.fasta").write_text("".join(out))
    with pytest.raises(SystemExit, match="sites"):
        _port_build(fixtures_dir, tmp_path / "wd",
                    _ardir(fixtures_dir, tmp_path / "ar"),
                    tmp_path / "short.fasta", fixtures_dir / "tiny.tree")


def test_fresh_run_truncated_output_aborts(tmp_path, fixtures_dir):
    """A fresh AR run (a fake ``raxml-ng`` script) whose posteriors are
    cut in half aborts with the truncation spelled out."""
    src = fixtures_dir / "raxmlng_ardir"
    lines = (src / AR_FILES[0]).read_text().splitlines()
    (tmp_path / "truncated.probas").write_text(
        "\n".join(lines[: len(lines) // 2]) + "\n")
    fake = tmp_path / "raxml-ng"
    fake.write_text(
        "#!/bin/sh\n"
        f"cp {src}/extended_align.phylip.raxml.ancestralTree .\n"
        f"cp {tmp_path}/truncated.probas "
        "extended_align.phylip.raxml.ancestralProbs\n")
    fake.chmod(0o755)
    cfg = BuildConfig(k=8, omega=1.5, states="nucl", ar_binary=str(fake))
    with pytest.raises(SystemExit, match="truncated"):
        build_database(fixtures_dir / "tiny.fasta",
                       fixtures_dir / "tiny.tree", tmp_path / "wd", cfg)
    assert (tmp_path / "wd" / "AR" / "AR_sdtout.txt").exists()


def test_ardir_missing_files_aborts(tmp_path, fixtures_dir):
    broken = tmp_path / "broken_ar"
    broken.mkdir()
    shutil.copy(fixtures_dir / "raxmlng_ardir" / AR_FILES[1], broken)
    with pytest.raises(FileNotFoundError):
        _port_build(fixtures_dir, tmp_path / "wd", broken,
                    fixtures_dir / "tiny.fasta", fixtures_dir / "tiny.tree")


# ------------------------------------------------------------------ #
# calibration and the CLI's other build outputs

def test_calibrate_equals_jax_and_is_deterministic():
    """The port's bound (plain versions on the CPU) is JAX's within 2e-4
    on the same DB and seed, and the same on a second run."""
    j = synthetic_db(seed=4, k=5, n_edges=8, n_kmers=500)
    p = port_db(j)
    kw = {"n_samples": 3000, "mean_length": 40, "batch_size": 512}
    bound = calibration.calibrate(p, device="cpu", **kw)
    assert np.isfinite(bound) and p.meta["calibration_ns_bound"] == bound
    assert abs(bound - jax_calibration.calibrate(j, **kw)) <= 2e-4
    assert calibration.calibrate(p, device="cpu", **kw) == bound
    assert calibration.LAST_RUN["reads"] == 3000
    assert bound > (40 - p.k + 1) * float(p.thr_log10)


def test_cli_calibration_bound_equals_jax(tmp_path, fixtures_dir,
                                          monkeypatch):
    """``-p b --ardir --calibration --device cpu`` saves a header bound
    within 2e-4 of the JAX CLI's (both at 20,000 reads)."""
    monkeypatch.setattr(calibration, "DEFAULT_SAMPLES", 20_000)
    monkeypatch.setattr(jax_calibration, "DEFAULT_SAMPLES", 20_000)
    bounds = []
    for name, main, extra in (("port", port_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        ar = _ardir(fixtures_dir, tmp_path / f"{name}_ar")
        wd = tmp_path / name
        assert main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                     "-t", str(fixtures_dir / "tiny.tree"),
                     "-b", "/fake/raxml-ng", "--ardir", str(ar),
                     "-w", str(wd), "--calibration", *extra]) == 0
        bounds.append(PhyloKmerDB.load(wd / "DB_k8_o1.5.rptpu")
                      .meta["calibration_ns_bound"])
    assert np.isfinite(bounds[0]) and abs(bounds[0] - bounds[1]) <= 2e-4


@pytest.mark.parametrize("extra", [[], ["--calibration"]],
                         ids=["plain", "calibrated"])
def test_cli_dbinram_places_as_jax(tmp_path, fixtures_dir, monkeypatch,
                                   extra):
    """``-p b --dbinram -q`` writes no DB and places as the JAX CLI does
    (the calibrated bound filters the same reads)."""
    monkeypatch.setattr(calibration, "DEFAULT_SAMPLES", 5_000)
    monkeypatch.setattr(jax_calibration, "DEFAULT_SAMPLES", 5_000)
    q = fixtures_dir / "tiny_reads.fasta"
    outs = []
    for name, main, dev in (("port", port_main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        ar = _ardir(fixtures_dir, tmp_path / f"{name}_ar")
        wd = tmp_path / name
        assert main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                     "-t", str(fixtures_dir / "tiny.tree"),
                     "-b", "/fake/raxml-ng", "--ardir", str(ar),
                     "-w", str(wd), "--dbinram", "-q", str(q), "--dp", "1",
                     "--batch-size", "16", *dev, *extra]) == 0
        assert not list(wd.glob("*.rptpu"))
        outs.append((
            json.loads((wd / "placements_tiny_reads.fasta.jplace")
                       .read_text()),
            (wd / "logs" / "placements_tiny_reads.fasta.tsv").read_text(),
            (wd / "logs" / "notplaced_tiny_reads.fasta.tsv").read_text()))
    _same_outputs(*outs[0], *outs[1])


def test_cli_jsondb_equals_jax(tmp_path, fixtures_dir):
    dumps = []
    for name, main in (("port", port_main), ("jax", jax_main)):
        ar = _ardir(fixtures_dir, tmp_path / f"{name}_ar")
        wd = tmp_path / name
        assert main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                     "-t", str(fixtures_dir / "tiny.tree"), "-k", "6",
                     "-b", "/fake/raxml-ng", "--ardir", str(ar),
                     "-w", str(wd), "--jsondb"]) == 0
        dumps.append((wd / "DB.json").read_bytes())
    assert dumps[0] == dumps[1] and len(json.loads(dumps[0])) > 100


@pytest.mark.parametrize("flag, note", [
    (["--extree", "somedir"], "--extree accepted for compatibility"),
    (["--dbfull"], "--dbfull accepted for compatibility"),
    (["--poshash"], "--poshash accepted for compatibility")])
def test_cli_compat_flags_logged(tmp_path, fixtures_dir, capsys, flag, note):
    """The reference's compat flags are accepted and their note logged,
    as ``rappas_tpu/cli.py:162-172`` logs it."""
    assert port_main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                      "-t", str(fixtures_dir / "tiny.tree"),
                      "-b", "/fake/bin/phyml", "-w", str(tmp_path),
                      "--arinputonly", *flag]) == 0
    out = capsys.readouterr().out
    assert note in out
    jax_main(["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
              "-t", str(fixtures_dir / "tiny.tree"), "-b", "/fake/bin/phyml",
              "-w", str(tmp_path / "jax"), "--arinputonly", *flag])
    assert [ln for ln in capsys.readouterr().out.splitlines()
            if "accepted for compatibility" in ln] == \
        [ln for ln in out.splitlines() if "accepted for compatibility" in ln]


def test_cli_build_needs_inputs(capsys):
    assert port_main(["-p", "b", "-w", "."]) == 2
    assert "-r/--refalign" in capsys.readouterr().err
