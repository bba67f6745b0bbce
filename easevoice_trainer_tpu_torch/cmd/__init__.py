"""Subprocess CLI entry points of the port, with the JAX package's contract:
``python -m easevoice_trainer_tpu_torch.cmd.<task> -c <params.json>`` runs
the task and writes the final EaseVoiceResponse (plus loss and session-data
lines) over the stdout connector protocol."""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from typing import Any, Callable, Dict

from easevoice_trainer_tpu.utils.connector import MultiProcessOutputConnector
from easevoice_trainer_tpu.utils.logger import logger
from easevoice_trainer_tpu.utils.response import EaseVoiceResponse, \
    ResponseStatus


def read_params() -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True,
                        help="path to the JSON params file")
    args = parser.parse_args()
    with open(args.config, encoding="utf-8") as f:
        return json.load(f)


def run_task(fn: Callable[[Dict[str, Any]], EaseVoiceResponse]) -> None:
    connector = MultiProcessOutputConnector()
    try:
        resp = fn(read_params())
    except Exception as e:  # the task's failure is the response
        logger.error("task failed: %s", traceback.format_exc())
        resp = EaseVoiceResponse(ResponseStatus.FAILED, str(e))
    connector.write_response(resp)


def filter_fields(params: Dict[str, Any], dataclass_type) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(dataclass_type)}
    return {k: v for k, v in params.items() if k in names}
