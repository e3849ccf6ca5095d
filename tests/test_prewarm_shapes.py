"""The compile prewarm must target exactly the shapes the real call uses."""

import numpy as np

import phylonium_tpu.ops.device_counts as dc
from phylonium_tpu.ops.shapes import packed_width, tile_for


def test_prewarm_shape_matches_wrapper_call(monkeypatch):
    """pair_counts_states's counting-program input == prewarm's shape
    (the serial path's state bytes; the streamed path's packed shape is
    pinned by test_stream.test_prewarm_stream_shapes).

    If the derivations drift, the background prewarm silently compiles
    a never-used executable and every run pays the compile again in the
    foreground.
    """
    calls = []
    real = dc._panel_counts

    def spy(dev, packed, interpret):
        calls.append((dev.shape, packed))
        return real(dev, packed, interpret)

    monkeypatch.setattr(dc, "_panel_counts", spy)
    lowered = []

    class FakeLower:
        @staticmethod
        def lower(spec, packed, interpret):
            lowered.append((spec.shape, packed))
            assert interpret  # CPU-pinned tests compile the interpreter

            class C:
                def compile(self):
                    return None

            return C()

    for n, length in [(3, 1000), (29, 50_000), (40, 7777)]:
        calls.clear()
        lowered.clear()
        states = np.random.default_rng(0).integers(
            0, 11, size=(n, length)
        ).astype(np.uint8)
        dc.pair_counts_states(states)
        monkeypatch.setattr(dc, "_panel_counts", FakeLower)
        dc.prewarm(n, length, packed=False)
        monkeypatch.setattr(dc, "_panel_counts", spy)
        assert calls == lowered, (n, length)


def test_packed_call_shape_properties():
    for n, length in [(1, 1), (29, 5_000_000), (512, 123_456), (1000, 10**6)]:
        for packed in (True, False):
            width = packed_width(length) if packed else length
            n_pad, w = dc.panel_shape(n, width)
            assert n_pad >= n and n_pad % tile_for(n_pad) == 0
            assert w % 64 == 0 and w >= width
            assert w <= max(1.125 * width, 128)  # one shape bucket
            assert dc.panel_shape(n, w) == (n_pad, w)  # idempotent
