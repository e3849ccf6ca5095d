"""Golden parity against the real reference binary.

Builds the reference phylonium (with this repo's SA-IS standing in for
libdivsufsort64 — see tests/oracle/build_oracle.sh) and asserts our CLI
produces byte-identical stdout on a spectrum of inputs: simf-simulated
pairs and families, multi-contig draft assemblies, inversions, all
--distance modes, --complete-deletion, -p refpos files, -r, and -2.

This is the strongest correctness guarantee in the suite: the
pipeline reproduces the reference's PHYLIP matrices exactly, matching
the BASELINE.json requirement.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
ORACLE_DIR = os.path.join(HERE, "oracle")
ORACLE_BIN = os.path.join(ORACLE_DIR, "bin", "phylonium")
SIMF_BIN = os.path.join(ORACLE_DIR, "bin", "simf")
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def oracle():
    if not os.path.exists(ORACLE_BIN):
        r = subprocess.run(
            ["sh", os.path.join(ORACLE_DIR, "build_oracle.sh")],
            capture_output=True,
            text=True,
        )
        if r.returncode != 0 or not os.path.exists(ORACLE_BIN):
            pytest.skip(f"oracle build failed: {r.stderr[-500:]}")
    return ORACLE_BIN


def run_oracle(args, cwd):
    r = subprocess.run(
        [ORACLE_BIN, *args], capture_output=True, text=True, cwd=cwd
    )
    return r.returncode, r.stdout, r.stderr


def run_ours(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # keep parity subprocesses on the CPU: fast, and no card needed
    env["PHYLONIUM_TPU_PLATFORM"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", *args],
        capture_output=True,
        text=True,
        cwd=cwd,
        env=env,
    )
    return r.returncode, r.stdout, r.stderr


def write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i : i + 70].decode("ascii") + "\n")


def make_panel(tmp_path, rng, n=4, length=30_000, contigs=False,
               inversion=False):
    from phylonium_tpu.data.sequence import revcomp

    acgt = np.frombuffer(b"ACGT", np.uint8)
    lut = np.zeros(256, np.uint8)
    for c, b in enumerate(b"ACGT"):
        lut[b] = c

    ref = rng.choice(acgt, length).tobytes()

    def mutate(s, p):
        arr = np.frombuffer(s, np.uint8).copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = acgt[(lut[arr[idx]] + rng.integers(1, 4, idx.size)) % 4]
        return arr.tobytes()

    files = []
    for k in range(n):
        g = ref if k == 0 else mutate(ref, 0.005 + 0.02 * k)
        if inversion and k == n - 1:
            third = length // 3
            g = g[:third] + revcomp(g[third : 2 * third]) + g[2 * third :]
        path = tmp_path / f"g{k}.fasta"
        if contigs and k % 2 == 1:
            quarter = len(g) // 4
            recs = [
                (f"g{k}c{j}", g[j * quarter : (j + 1) * quarter])
                for j in range(4)
            ]
        else:
            recs = [(f"g{k}", g)]
        write_fasta(path, recs)
        files.append(f"g{k}.fasta")
    return files


def assert_parity(args, cwd, check_returncode=True):
    rc_o, out_o, err_o = run_oracle(args, cwd)
    rc_t, out_t, err_t = run_ours(args, cwd)
    assert out_t == out_o, (
        f"stdout differs for {args}:\n--- reference ---\n{out_o}\n"
        f"--- ours ---\n{out_t}\n--- our stderr ---\n{err_t[-2000:]}"
    )
    if check_returncode:
        assert rc_t == rc_o, (args, rc_o, rc_t, err_o, err_t)


def test_simf_pair(oracle, tmp_path):
    subprocess.run(
        [SIMF_BIN, "-s", "7", "-l", "50000", "-d", "0.1", "-p",
         str(tmp_path) + "/s"],
        check=True,
    )
    assert_parity(["s0.fasta", "s1.fasta"], tmp_path)


def test_simf_family_distances(oracle, tmp_path):
    subprocess.run(
        [SIMF_BIN, "-s", "11", "-l", "40000", "-d", "0.05", "-d", "0.15",
         "-d", "0.3", "-p", str(tmp_path) + "/f"],
        check=True,
    )
    files = [f"f{k}.fasta" for k in range(4)]
    assert_parity(files, tmp_path)
    assert_parity(["--distance", "raw", *files], tmp_path)
    assert_parity(["--distance", "ani", *files], tmp_path)


def test_panel_basic(oracle, tmp_path):
    rng = np.random.default_rng(1)
    files = make_panel(tmp_path, rng)
    assert_parity(files, tmp_path)


def test_panel_contigs_and_inversion(oracle, tmp_path):
    rng = np.random.default_rng(2)
    files = make_panel(tmp_path, rng, contigs=True, inversion=True)
    assert_parity(files, tmp_path)


def test_complete_deletion(oracle, tmp_path):
    rng = np.random.default_rng(3)
    files = make_panel(tmp_path, rng, contigs=True)
    assert_parity(["--complete-deletion", *files], tmp_path)


def test_refpos_output(oracle, tmp_path):
    rng = np.random.default_rng(4)
    files = make_panel(tmp_path, rng, n=3)
    rc_o, out_o, _ = run_oracle(["-p", "ref.pos", *files], tmp_path)
    pos_o = (tmp_path / "ref.pos").read_text()
    (tmp_path / "ref.pos").unlink()
    rc_t, out_t, err_t = run_ours(["-p", "ref.pos", *files], tmp_path)
    pos_t = (tmp_path / "ref.pos").read_text()
    assert out_t == out_o
    assert pos_t == pos_o, f"refpos differs:\n{pos_o[:500]}\nvs\n{pos_t[:500]}"


def test_explicit_reference(oracle, tmp_path):
    rng = np.random.default_rng(5)
    files = make_panel(tmp_path, rng, n=3)
    assert_parity(["-r", files[2], *files[:2]], tmp_path)


def test_two_pass(oracle, tmp_path):
    rng = np.random.default_rng(6)
    files = make_panel(tmp_path, rng, n=4)
    assert_parity(["-2", *files], tmp_path)


def test_low_coverage_warning_and_exit(oracle, tmp_path):
    # unrelated sequences: nan distances, soft-error exit code 1
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    write_fasta(tmp_path / "a.fasta", [("a", rng.choice(acgt, 5000).tobytes())])
    write_fasta(tmp_path / "b.fasta", [("b", rng.choice(acgt, 5000).tobytes())])
    assert_parity(["a.fasta", "b.fasta"], tmp_path)


def test_identical_sequences(oracle, tmp_path):
    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(acgt, 20000).tobytes()
    write_fasta(tmp_path / "a.fasta", [("a", g)])
    write_fasta(tmp_path / "b.fasta", [("b", g)])
    assert_parity(["a.fasta", "b.fasta"], tmp_path)


def test_heavy_draft_assembly(oracle, tmp_path):
    """Draft assemblies with ~200 contigs each plus strand flips
    (BASELINE.json config 4)."""
    from phylonium_tpu.data.sequence import revcomp

    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lut = np.zeros(256, np.uint8)
    for c, b in enumerate(b"ACGT"):
        lut[b] = c
    length = 60_000
    ref = rng.choice(acgt, length).tobytes()

    def mutate(s, p):
        arr = np.frombuffer(s, np.uint8).copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = acgt[(lut[arr[idx]] + rng.integers(1, 4, idx.size)) % 4]
        return arr.tobytes()

    write_fasta(tmp_path / "ref.fasta", [("ref", ref)])
    for g in range(2):
        seq = mutate(ref, 0.01 + 0.02 * g)
        n_contigs = 200
        size = length // n_contigs
        recs = []
        for k in range(n_contigs):
            contig = seq[k * size : (k + 1) * size]
            if k % 3 == 1:  # flip every third contig to the minus strand
                contig = revcomp(contig)
            recs.append((f"d{g}c{k}", contig))
        write_fasta(tmp_path / f"d{g}.fasta", recs)

    assert_parity(["ref.fasta", "d0.fasta", "d1.fasta"], tmp_path)


def test_heavily_fragmented_draft(oracle, tmp_path, rng):
    """Draft assemblies with 100s of contigs (BASELINE.md config #4):
    one genome split into 300 contigs with every other contig
    reverse-complemented — the '!' joins and strand projection must
    stay byte-identical through the revseqcmp-equivalent path."""
    from phylonium_tpu.data.sequence import revcomp

    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 120_000)
    files = []
    for k in range(4):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.01 * (k + 1)
        arr[idx] = acgt[(arr[idx] + 1) % 4]
        path = tmp_path / f"D{k}.fasta"
        with open(path, "w") as f:
            if k == 3:  # the fragmented draft
                cuts = np.sort(rng.integers(1, arr.size - 1, 299))
                parts = np.split(arr, cuts)
                for ci, part in enumerate(parts):
                    if ci % 2:
                        part = np.frombuffer(
                            revcomp(part.tobytes()), np.uint8
                        )
                    f.write(f">D{k}_c{ci}\n")
                    s = part.tobytes().decode()
                    for i in range(0, len(s), 70):
                        f.write(s[i : i + 70] + "\n")
            else:
                f.write(f">D{k}\n")
                s = arr.tobytes().decode()
                for i in range(0, len(s), 70):
                    f.write(s[i : i + 70] + "\n")
        files.append(path.name)

    rc_o, out_o, _ = run_oracle(sorted(files), str(tmp_path))
    rc_t, out_t, err_t = run_ours(
        ["--progress=never", *sorted(files)], str(tmp_path)
    )
    assert rc_o == rc_t
    assert out_t == out_o, err_t[-500:]


def test_repeated_distance_flags_sticky_bits(oracle, tmp_path, rng):
    """--distance choices accumulate as STICKY flag bits in the
    reference (src/phylonium.cxx:147-158): the estimator takes
    raw > ani > jc precedence while the FORMATTER keys on the ani bit
    alone (src/io.cxx:149) — '--distance=ani --distance=raw' therefore
    prints raw values in defaultfloat.  Caught by a 200-seed
    flag-surface campaign."""
    files = make_panel(tmp_path, rng, n=3, length=20_000)
    for combo in (
        ["--distance=ani", "--distance=raw"],
        ["--distance", "raw", "--distance=jc"],
        ["--distance=raw", "--distance=ani"],
        ["--distance=jc", "--distance=ani"],
    ):
        rc_o, out_o, _ = run_oracle([*combo, *files], str(tmp_path))
        rc_t, out_t, err_t = run_ours(
            ["--progress=never", *combo, *files], str(tmp_path)
        )
        assert rc_o == rc_t, combo
        assert out_t == out_o, (combo, err_t[-300:])
