import os
import sys

from phylonium_tpu.cli import main

if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as e:
        rc = int(e.code) if isinstance(e.code, int) else 1
    except KeyboardInterrupt:
        rc = 130  # conventional SIGINT exit, no traceback noise
    except BaseException:
        # Any crash must still leave through os._exit below: a normal
        # interpreter teardown kills daemon device threads mid-call
        # inside the device runtime and can abort with "terminate
        # called ..." (SIGABRT), burying the actual traceback.
        import traceback

        traceback.print_exc()
        rc = 1
    # Perf invariant (tested): a host-dispatched run must never import
    # jax — the import alone costs ~1.8 s.
    if os.environ.get("PHYLONIUM_TPU_EXPECT_NO_JAX") and "jax" in sys.modules:
        print(
            "PHYLONIUM_TPU_EXPECT_NO_JAX: jax was imported on a "
            "host-only run",
            file=sys.stderr,
        )
        rc = rc or 70
    # Hard exit: background device threads (backend init, the compare
    # race's losing side, prewarm compiles) may still be inside the
    # device runtime; normal interpreter teardown can abort with
    # "terminate called ..." when it kills them mid-call.  All outputs
    # are written and flushed by main(); nothing below us needs atexit.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
