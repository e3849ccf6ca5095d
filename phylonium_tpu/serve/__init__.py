"""Device server: one long-lived process holding the device session.

Every CLI invocation is a fresh process that pays backend start-up and
program loading before its first device result.  The device server
keeps one resident process with the warm jax session, the compiled
program family and the device-side panel state; CLI runs talk to it
over a unix socket.  It is off by default and engaged with
``PHYLONIUM_TPU_DEVD=1``; the CLI process then never opens the card,
so one process holds it.  Whether it pays on a locally attached GPU is
an open, measured question.

The reference (a one-shot CPU binary, `src/phylonium.cxx:89-299`) has
no counterpart.

Layout: wire.py (length-prefixed JSON + raw numpy frames), daemon.py
(the server; ``python -m phylonium_tpu.serve``), client.py
(connect-or-spawn client used by the stream feeder and query shipper).
"""
