"""TensorBoard sidecar: a background ``tensorboard`` process on :6006
(JAX: service/tensorboard.py), started where the binary is on ``PATH``; the
REST layer proxies /apis/v1/tensorboard/* to it.
"""
from __future__ import annotations

import shutil
import subprocess
import threading
from typing import Optional

from ..utils import paths
from ..utils.logger import logger

TENSORBOARD_PORT = 6006


class TensorBoardService:
    def __init__(self, logdir: Optional[str] = None,
                 port: int = TENSORBOARD_PORT):
        self.logdir = logdir or paths.tb_log_dir()
        self.port = port
        self.process: Optional[subprocess.Popen] = None

    def run_tensorboard(self) -> None:
        if shutil.which("tensorboard") is None:
            logger.warning("tensorboard binary not found; service disabled")
            return
        self.process = subprocess.Popen(
            ["tensorboard", "--logdir", self.logdir, "--port",
             str(self.port), "--bind_all"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        logger.info("tensorboard started on :%d (logdir=%s)", self.port,
                    self.logdir)

    def start(self) -> None:
        threading.Thread(target=self.run_tensorboard, daemon=True).start()

    def stop(self) -> None:
        if self.process is not None:
            self.process.terminate()
            self.process = None
