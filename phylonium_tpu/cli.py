"""Command-line driver.

Flag surface and behavior mirror the reference's getopt_long loop
(`src/phylonium.cxx:89-299`):

  -2, --2pass            two-pass algorithm (recompute with the most
                         central genome as reference)
  -b, --bootstrap=N      print N-1 additional bootstrap matrices
                         (the reference stores N-1, src/phylonium.cxx:179)
  --complete-deletion    restrict to columns covered in every genome
  --distance=OPT         raw | jc | ani (bad values: soft error, ignored)
  -p FILE                write reference positions/segsites to FILE
                         (implies complete deletion; refuses to overwrite)
  --progress[=WHEN]      always | auto | never (default auto: stderr TTY)
  -r FILE                set the reference genome (file list is dedup'd
                         and sorted with the reference included,
                         src/phylonium.cxx:384-391)
  -t, --threads=N        host thread count
  -v, --verbose          additional information (repeatable)
  -h, --help / --version

Accelerator additions:
  --esa-backend=B        native | numpy | auto
  --count-backend=B      device | pallas | host | numpy | auto
  --map-backend=B        native | python | hybrid | auto
"""

from __future__ import annotations

import sys

import numpy as np

from phylonium_tpu import __version__
from phylonium_tpu.config import ConfigError, PROG, RunConfig
from phylonium_tpu.core.pipeline import process
from phylonium_tpu.core.reference_pick import pick_first_pass, pick_second_pass
from phylonium_tpu.data.sequence import join
from phylonium_tpu.io.fasta import read_genome
from phylonium_tpu.io.phylip import print_matrix

USAGE = """Usage: phylonium-tpu [OPTIONS] FILES...
\tEach FASTA file is one genome (multi-contig files are fine).

Options:
  -2, --2pass          Rerun with the most central genome as reference
  -b, --bootstrap=N    Also print N-1 bootstrapped distance matrices
  --complete-deletion  Keep only reference columns covered in every genome
  -p FILE              Write per-column variant positions to FILE
                       (turns on complete deletion)
    --progress=WHEN    Progress bars on stderr: always/never/auto (default)
  -r FILE              Use FILE's genome as the mapping reference
  -t, --threads=N      Host worker threads (default: all cores)
  -v, --verbose        More diagnostics on stderr (repeat for timings)
      --distance=OPT   Output scale: 'jc' (default), 'raw', or 'ani'
      --esa-backend=B  Suffix index: 'native', 'numpy', or 'auto' (default)
      --count-backend=B  Pair counting: 'device' (alias 'pallas': the
                       fused device kernel), 'host', 'numpy', or 'auto'
                       (default: race the device kernel against the
                       host while it compiles)
      --map-backend=B  Mapping: 'native', 'python', 'hybrid' (device
                       anchor extension), or 'auto' (default)
      --mesh=R,C       Count across an RxC device mesh (default: every
                       visible device when more than one is present)
      --checkpoint=DIR Reuse/persist anchor-mapping results in DIR
                       (content-addressed; reruns and grown panels skip
                       already-mapped genomes)
      --profile=DIR    Write a jax.profiler trace of the run to DIR
  -h, --help           This text
      --version        Version and citation information
"""


def _strtoul10(val: str) -> int | None:
    """glibc strtoul(s, &end, 10) with the reference's *end=='\\0' check:
    optional leading whitespace and sign, base-10 digits, nothing after.
    A negative value WRAPS mod 2^64; digits beyond ULONG_MAX are ERANGE
    (None).  Numeric flags (-b, -t) must share these exact semantics
    (src/phylonium.cxx:166-199) — e.g. '-b -1' means 2^64-1 matrices."""
    import re

    m = re.match(r"[ \t\n\r\f\v]*([+-])?([0-9]+)\Z", val)
    if not m:
        return None
    digits = int(m.group(2))
    if digits > 0xFFFFFFFFFFFFFFFF:
        return None
    return (-digits if m.group(1) == "-" else digits) % (1 << 64)


def usage(status: int) -> "NoReturn":  # noqa: F821
    out = sys.stdout if status == 0 else sys.stderr
    out.write(USAGE)
    sys.exit(status)


def version() -> "NoReturn":  # noqa: F821
    print(
        f"phylonium-tpu {__version__}\n"
        "A JAX (XLA/Pallas) alignment-free distance engine\n"
        "implementing the method of phylonium (Kloetzl & Haubold 2020)."
    )
    sys.exit(0)


def cleanup_names(reference_name: str, file_names: list[str]) -> list[str]:
    """Add the reference, sort, dedup (src/phylonium.cxx:384-391)."""
    file_names = file_names + [reference_name]
    return sorted(set(file_names))


def _expand_bundles(argv: list[str]) -> list[str]:
    """getopt-style short-option bundling: -2v == -2 -v, -b5 == -b 5.

    Options taking a value (b, p, r, t) consume the rest of the token.
    """
    value_opts = "bprt"
    out: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--":
            out.extend(argv[i:])
            break
        if len(arg) > 2 and arg[0] == "-" and arg[1] != "-":
            k = 1
            while k < len(arg):
                c = arg[k]
                out.append(f"-{c}")
                if c in value_opts:
                    rest = arg[k + 1 :]
                    if rest:
                        out.append(rest)
                    break
                k += 1
        else:
            out.append(arg)
        i += 1
    return out


# every long option, for getopt_long-style unambiguous-prefix matching
_LONG_OPTS = (
    "2pass", "bootstrap", "complete-deletion", "distance", "help",
    "progress", "threads", "verbose", "version", "esa-backend",
    "count-backend", "map-backend", "mesh", "checkpoint", "profile",
)


def _canonical_long(arg: str) -> str:
    """Resolve '--boot' to '--bootstrap' like getopt_long does; exact
    names win, ambiguous or unknown prefixes pass through (and fail
    downstream like any unknown option)."""
    name, eq, value = arg[2:].partition("=")
    if name in _LONG_OPTS:
        return arg
    hits = [o for o in _LONG_OPTS if o.startswith(name)] if name else []
    if len(hits) == 1:
        return f"--{hits[0]}{eq}{value}"
    return arg


def parse_args(argv: list[str]) -> tuple[RunConfig, list[str]]:
    cfg = RunConfig()
    files: list[str] = []
    argv = _expand_bundles(argv)
    canon: list[str] = []
    seen_dashes = False
    for a in argv:
        seen_dashes = seen_dashes or a == "--"
        if not seen_dashes and a.startswith("--"):
            a = _canonical_long(a)
        canon.append(a)
    argv = canon
    i = 0

    def take_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            usage(1)
        return argv[i]

    want_version = False
    while i < len(argv):
        arg = argv[i]
        if arg == "--":
            files.extend(argv[i + 1 :])
            break
        elif arg in ("-2", "--2pass"):
            cfg.two_pass = True
        elif arg == "-b" or arg == "--bootstrap" or arg.startswith("--bootstrap="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            bootstrap = _strtoul10(val)
            if bootstrap:  # junk/ERANGE (None) and 0 both soft-error
                cfg.bootstrap = bootstrap - 1
            else:
                cfg.soft_error(
                    f"Expected a positive number for -b argument, but "
                    f"'{val}' was given. Ignoring -b argument."
                )
        elif arg == "--complete-deletion":
            cfg.complete_deletion = True
        elif arg == "--distance" or arg.startswith("--distance="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            low = val.lower()
            if low in ("raw", "jc", "ani"):
                # sticky bits, reference semantics: repeats OR together,
                # 'jc' sets nothing; estimator precedence raw > ani > jc
                if low == "raw":
                    cfg.dist_raw = True
                elif low == "ani":
                    cfg.dist_ani = True
                cfg.distance = (
                    "raw" if cfg.dist_raw
                    else "ani" if cfg.dist_ani
                    else "jc"
                )
            else:
                cfg.soft_error(
                    f"ignoring argument for --distance '{val}' expected "
                    "one of 'raw', 'jc', or 'ani'"
                )
        elif arg in ("-h", "--help"):
            usage(0)
        elif arg == "-p":
            cfg.print_positions = True
            cfg.complete_deletion = True
            cfg.refpos_file_name = take_value(arg)
        elif arg == "--progress" or arg.startswith("--progress="):
            val = arg.split("=", 1)[1] if "=" in arg else "always"
            low = val.lower()
            if low in ("always", "auto", "never"):
                cfg.progress = low
            else:
                cfg.warn(
                    f"invalid argument to --progress '{val}'. Expected one "
                    "of 'auto', 'always', or 'never'."
                )
        elif arg == "-r":
            cfg.reference_name = take_value(arg)
        elif arg in ("-t", "--threads") or arg.startswith("--threads="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            threads = _strtoul10(val)
            if threads is None:
                cfg.warn(
                    f"Expected a number for -t argument, but '{val}' was "
                    "given. Ignoring -t argument."
                )
            else:
                from phylonium_tpu.native import num_procs

                if threads > num_procs():
                    # reference wording verbatim, typo included
                    # (src/phylonium.cxx:179-183): a wrapped negative
                    # lands here with its mod-2^64 value
                    cfg.warn(
                        "The number of threads to be used, is greater "
                        "then the number of available processors; "
                        f"Ignoring -t {threads} argument."
                    )
                else:
                    cfg.threads = threads
        elif arg in ("-v", "--verbose"):
            cfg.verbose += 1
        elif arg == "--version":
            want_version = True
        elif arg == "--esa-backend" or arg.startswith("--esa-backend="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            if val in ("auto", "native", "numpy"):
                cfg.esa_backend = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --esa-backend '{val}' expected "
                    "one of 'auto', 'native', or 'numpy'"
                )
        elif arg == "--count-backend" or arg.startswith("--count-backend="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            if val in ("auto", "pallas", "device", "host", "numpy"):
                cfg.count_backend = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --count-backend '{val}' "
                    "expected one of 'auto', 'pallas', 'device', 'host', "
                    "or 'numpy'"
                )
        elif arg == "--mesh" or arg.startswith("--mesh="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            parts = val.split(",")
            if all(p.isdigit() and int(p) > 0 for p in parts) and len(
                parts
            ) in (1, 2):
                cfg.mesh = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --mesh '{val}' expected "
                    "'R,C' with positive integers"
                )
        elif arg == "--map-backend" or arg.startswith("--map-backend="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            if val in ("auto", "native", "python", "hybrid"):
                cfg.map_backend = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --map-backend '{val}' expected "
                    "one of 'auto', 'native', 'python', or 'hybrid'"
                )
        elif arg == "--checkpoint" or arg.startswith("--checkpoint="):
            cfg.checkpoint_dir = (
                arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            )
        elif arg == "--profile" or arg.startswith("--profile="):
            cfg.profile_dir = (
                arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            )
        elif arg.startswith("--"):
            # getopt_long's diagnostic line precedes the usage text;
            # a prefix matching several long options gets the
            # "ambiguous" form (our extra options can make a prefix
            # ambiguous that is unique in the reference's table —
            # inherent to extending the surface)
            name = arg[2:].partition("=")[0]
            hits = (
                [o for o in _LONG_OPTS if o.startswith(name)]
                if name else []
            )
            if len(hits) > 1:
                poss = " ".join(f"'--{o}'" for o in hits)
                print(
                    f"{PROG}: option '{arg}' is ambiguous; "
                    f"possibilities: {poss}",
                    file=sys.stderr,
                )
            else:
                print(
                    f"{PROG}: unrecognized option '{arg}'",
                    file=sys.stderr,
                )
            usage(1)
        elif arg.startswith("-") and arg != "-":
            # bundles were pre-split, so an unknown short is one char
            print(
                f"{PROG}: invalid option -- '{arg[1:]}'", file=sys.stderr
            )
            usage(1)
        else:
            files.append(arg)
        i += 1

    if want_version:
        version()

    return cfg, files


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cfg, file_names = parse_args(argv)

    import os

    # PHYLONIUM_TPU_PLATFORM is applied lazily at the jax-touching
    # chokepoints (utils/platform.apply_platform_override): applying it
    # here would import jax (~1.8 s) even for runs whose work-based
    # dispatch never leaves the host.

    if cfg.print_positions:
        if os.path.exists(cfg.refpos_file_name):
            print(
                f"{PROG}: output file '{cfg.refpos_file_name}' already "
                "exists",
                file=sys.stderr,
            )
            return 1

    if cfg.reference_name:
        file_names = cleanup_names(cfg.reference_name, file_names)

    if len(file_names) < 2:
        usage(1)

    if cfg.threads:
        from phylonium_tpu.native import num_procs, set_threads

        if cfg.threads > num_procs():
            cfg.warn(
                "The number of threads to be used, is greater then the "
                f"number of available processors; Ignoring -t "
                f"{cfg.threads} argument."
            )
            cfg.threads = 0
        else:
            set_threads(cfg.threads)

    # device-bound big panels: ship 2-bit query codes DURING the read
    # phase (core/query_ship.py) — the link is the wall for device
    # counting, and read+index seconds were dead time on it.  Gated on
    # measured link bandwidth + file sizes; best-effort (a failed
    # shipper reverts to feed-time shipping, bit-identically).
    from phylonium_tpu.core.query_ship import early_ship_eligible

    # low-memory mode (core/lowmem.py): predicted from file sizes so
    # sequences 2-bit-compact AT READ TIME — the raw panel never
    # materializes.  The pipeline re-decides with exact sizes (the
    # compaction is transparent either way).
    lowmem_group = None
    try:
        from phylonium_tpu.core.lowmem import (
            group_rows_for,
            should_lowmem,
        )

        est_bp = int(
            sum(os.path.getsize(f) for f in file_names) * 0.98
        )
        if should_lowmem(len(file_names), est_bp, cfg):
            lowmem_group = group_rows_for(
                len(file_names), max(1, est_bp // len(file_names))
            )
    except OSError:
        pass

    if early_ship_eligible(cfg, file_names):
        try:
            from phylonium_tpu.core.query_ship import QueryShipper

            cfg._query_shipper = QueryShipper(
                len(file_names), group_rows=lowmem_group
            )
        except Exception:
            cfg._query_shipper = None

    try:
        # parallel file reading, the analogue of the reference's
        # omp-parallel read loop (src/phylonium.cxx:272-275).
        # Read-ahead is BOUNDED: Executor.map schedules every file up
        # front, and finished-but-unconsumed futures each pin a whole
        # raw genome — measured GBs of hoarded read-ahead at the
        # 1000 x 5 Mbp tier while the consumer compacted behind 8
        # parallel readers.
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        workers = max(cfg.threads or min(8, len(file_names)), 1)

        def bounded_reads(pool, ahead):
            pending = deque()
            for name in file_names:
                pending.append(pool.submit(read_genome, name))
                if len(pending) >= ahead:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

        with ThreadPoolExecutor(max_workers=workers) as pool:
            queries = []
            for g in bounded_reads(pool, 2 * workers):
                q = join(g)
                queries.append(q)
                if lowmem_group is not None:
                    # compact FIRST: the shipper then works zero-copy
                    # from the per-genome packs (raw views pinned in
                    # its queue blew the low-mem RSS bound)
                    q.compact()
                if cfg._query_shipper is not None:
                    if q.compacted:
                        cfg._query_shipper.add_seq(q)
                    else:
                        cfg._query_shipper.add(q.as_array())
    except OSError as e:
        # err(errno, ...)-style failure (src/io.cxx:73-74)
        print(f"{PROG}: {e.filename}: {e.strerror}", file=sys.stderr)
        return e.errno or 1
    except ValueError as e:  # FastaError and friends
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1

    if cfg.reference_name:
        reference_index = file_names.index(cfg.reference_name)
    else:
        reference_index = pick_first_pass(queries, verbose=bool(cfg.verbose))

    # The persistent compile cache is enabled at the device-touching
    # chokepoints (prewarm worker, the counting paths, hybrid mapping,
    # the stream feeder) rather than here: enabling it means importing
    # jax, which costs ~1.8 s, and a host-dispatched run must never pay
    # that (tested: PHYLONIUM_TPU_EXPECT_NO_JAX).

    # device-bound runs: start backend init now (seconds) so it overlaps
    # the host index/map phases.  Panels the work-based dispatch keeps
    # on the host never touch the device runtime at all
    # (core/pipeline._auto_prefers_host), and with the device server
    # engaged this process never opens the card.
    from phylonium_tpu.core.pipeline import _auto_prefers_host
    from phylonium_tpu.serve.client import devd_enabled

    if (
        cfg.count_backend not in ("numpy", "host")
        and not devd_enabled()
        and not _auto_prefers_host(
            len(queries), len(queries[reference_index]), cfg
        )
    ):
        import threading

        def _init_backend():
            try:
                from phylonium_tpu.utils.platform import device_setup

                device_setup()
                import jax

                jax.devices()
                # take the first-transfer set-up off the critical path
                # (core/query_ship.warm_link)
                from phylonium_tpu.core.query_ship import warm_link

                warm_link()
            except Exception:
                pass  # the device path itself reports its errors

        threading.Thread(
            target=_init_backend, daemon=True, name="backend-init"
        ).start()

    if cfg.profile_dir:
        from phylonium_tpu.utils.platform import apply_platform_override

        apply_platform_override()
        import jax

        jax.profiler.start_trace(cfg.profile_dir)

    try:
        counts = process(queries[reference_index], queries, cfg)

        if cfg.two_pass:
            second_index = pick_second_pass(counts)
            if second_index == reference_index:
                # the central genome IS the pass-1 reference: the second
                # pass would redo the identical (deterministic) run, so
                # reuse it.  (A changed pick cannot reuse anything —
                # homologies live in subject coordinates.)  The reference
                # recomputes unconditionally (src/phylonium.cxx:289-292).
                if cfg.verbose:
                    print(
                        f"ref: {queries[reference_index].name}",
                        file=sys.stderr,
                    )
            else:
                reference_index = second_index
                counts = process(queries[reference_index], queries, cfg)
    except ConfigError as e:
        # configuration/limit errors surfaced by the pipeline (backend
        # combinations, mesh-vs-device mismatch, index limits) fail
        # cleanly instead of with a traceback; any other exception is a
        # defect and keeps its traceback
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    finally:
        if cfg.profile_dir:
            import jax

            jax.profiler.stop_trace()

    # multi-host SPMD: every process computes the (identical, bit-exact)
    # matrix; only the coordinator prints it.  The distributed state is
    # read directly (jax.process_count() may initialize the backend).
    from phylonium_tpu.utils.platform import distributed_state

    nproc, pid = distributed_state()
    if nproc > 1 and pid != 0:
        return cfg.return_code

    names = [q.name for q in queries]
    lengths = np.array([len(q) for q in queries], dtype=np.int64)
    print_matrix(cfg, names, lengths, counts, reference_index)

    report_path = os.environ.get("PHYLONIUM_TPU_RUN_REPORT")
    if report_path:
        # machine-readable run report (observability only; written after
        # the matrix so it never perturbs timed output): which leg
        # ACTUALLY carried the compare, plus phase timings.  bench.py
        # uses it to label e2e tiers with the real dispatch instead of
        # the planned one.
        try:
            import json

            from phylonium_tpu.core.pipeline import LAST_RUN_INFO

            with open(report_path, "w") as f:
                json.dump(LAST_RUN_INFO, f)
        except Exception as e:  # never fail the run over a report
            cfg.warn(f"could not write run report: {e}")

    return cfg.return_code


if __name__ == "__main__":
    sys.exit(main())
