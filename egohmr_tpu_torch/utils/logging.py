"""Run logging (port of egohmr_tpu/utils/logging.py): a timestamped file
logger, the run's flags as `params.json`, and scalars to `metrics.jsonl`
(and to TensorBoard when tensorboardX is importable)."""
from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Dict


def get_logger(logdir: str, name: str = "egohmr_tpu_torch") -> logging.Logger:
    """A logger to `<logdir>/run_<timestamp>.log` and to stderr. Handlers of
    an earlier call are closed, so a second run in one process logs once."""
    os.makedirs(logdir, exist_ok=True)
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    handler = logging.FileHandler(os.path.join(logdir, f"run_{ts}.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.addHandler(logging.StreamHandler())
    logger.setLevel(logging.INFO)
    return logger


def save_config(logdir: str, config: Dict) -> None:
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "params.json"), "w") as f:
        json.dump(config, f, indent=4, sort_keys=True, default=str)


class MetricsWriter:
    """Scalars to `<logdir>/metrics.jsonl`, appended, one JSON object per
    write (plus TensorBoard when tensorboardX is importable)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(logdir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """`MetricsWriter`'s interface, writing nothing: the writer of a
    data-parallel rank other than 0."""

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


def null_logger(name: str = "egohmr_tpu_torch.rank") -> logging.Logger:
    """A logger that writes nothing: the logger of a data-parallel rank
    other than 0."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger
