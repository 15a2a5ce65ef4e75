"""The program's scan server with a fault planted under its timed path,
for the tests that see ``correct`` come out false:

    python -m scanbench.tests.faulty_server <fault> <socket>

``half_batch``: the device scan's flags for the second half of every
buffer are dropped, as if half of the batch were left out.
``altered_answer``: one byte of every output buffer is changed where the
emitter produces it."""

import sys


def plant(fault: str) -> None:
    if fault == "half_batch":
        from grab_tpu_torch import scan_pipeline

        resolve = scan_pipeline.DeviceScanner.resolve

        def half(self, handles):
            flags = resolve(self, handles)
            flags[flags.shape[0] // 2:] = 0
            return flags

        scan_pipeline.DeviceScanner.resolve = half
    elif fault == "altered_answer":
        from grab_tpu_torch.format import emitter

        scan_buffer = emitter.ChunkReplayer.scan_buffer

        def altered(self, path, data, emit):
            def emit_altered(buf: bytes):
                emit(bytes([buf[0] ^ 0x20]) + buf[1:] if buf else buf)

            return scan_buffer(self, path, data, emit_altered)

        emitter.ChunkReplayer.scan_buffer = altered
    else:
        raise SystemExit(f"unknown fault {fault}")


if __name__ == "__main__":
    plant(sys.argv[1])
    from grab_tpu_torch.server import serve

    serve(sys.argv[2])
