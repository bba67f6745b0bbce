"""Server bootstrap: ``python -m easevoice_trainer_tpu_torch.main [--dry-run]
[--device cuda|cpu]`` (JAX: main.py).

Serves the REST app on 0.0.0.0:$EASEVOICE_PORT (default 8000) on one
device: the card unless ``--device cpu`` asks for the host; without a card
the default exits non-zero with the device's error.  ``--dry-run`` boots
the app, binds the port, then exits: the startup smoke check.
"""
from __future__ import annotations

import argparse
import os
import signal

from .rest.app import build_app
from .utils.logger import logger

HOST = "0.0.0.0"
PORT = int(os.environ.get("EASEVOICE_PORT", "8000"))


def serve(dry_run: bool, device: str) -> None:
    server = build_app(device=device).make_server(HOST, PORT)
    logger.info("serving on http://%s:%d (device %s)", HOST, PORT, device)
    if dry_run:
        # bound and closed; the startup hooks (TensorBoard's start) do not
        # run, so no process outlives the check
        logger.info("dry-run: server started OK, shutting down")
        server.server_close()
        return
    # SIGTERM ends the server as Ctrl-C does: the cleanup hooks run
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    server.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close_app()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dry-run", action="store_true",
                        help="boot the server, then exit immediately")
    parser.add_argument("--device", default="cuda",
                        help="the device the server and its tasks run on "
                             "(default: the card)")
    args = parser.parse_args()
    serve(args.dry_run, args.device)


if __name__ == "__main__":
    main()
