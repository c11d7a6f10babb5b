"""Training-curve scraping helpers (reference wm_basicsr/utils/plot_util.py,
83 LoC), the port's copy of comfyui_keep_tpu/utils/plot.py: pull scalar
series out of tensorboard event files or text logs and apply the
tensorboard-style IIR smoothing. Torch-free; `tensorboard` is an optional
dependency imported at call time.
"""
import re
from typing import List, Sequence, Tuple


def read_data_from_tensorboard(log_path: str, tag: str) -> Tuple[List[int], List[float]]:
    """(steps, values) of one scalar tag from a tensorboard event dir/file
    (plot_util.py:4-21)."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(log_path)
    acc.Reload()
    scalars = acc.Scalars(tag)
    return [int(s.step) for s in scalars], [s.value for s in scalars]


def read_data_from_txt_2v(path: str, pattern: str,
                          step_one: bool = False) -> Tuple[List[int], List[float]]:
    """(steps, values) matched by a 2-group regex, line by line
    (plot_util.py:24-46). step_one shifts steps by +1."""
    compiled = re.compile(pattern)
    steps: List[int] = []
    values: List[float] = []
    with open(path) as f:
        for line in f:
            m = compiled.match(line.strip())
            if m:
                steps.append(int(m.group(1)))
                values.append(float(m.group(2)))
    if step_one:
        steps = [s + 1 for s in steps]
    return steps, values


def read_data_from_txt_1v(path: str, pattern: str) -> List[float]:
    """Values matched by a 1-group regex (plot_util.py:49-65)."""
    compiled = re.compile(pattern)
    out: List[float] = []
    with open(path) as f:
        for line in f:
            m = compiled.match(line.strip())
            if m:
                out.append(float(m.group(1)))
    return out


def smooth_data(values: Sequence[float], smooth_weight: float) -> List[float]:
    """Tensorboard's 1st-order IIR low-pass smoothing (plot_util.py:68-83):
    y[i] = w*y[i-1] + (1-w)*x[i], seeded with x[0]."""
    out: List[float] = []
    last = values[0]
    for v in values:
        last = last * smooth_weight + (1 - smooth_weight) * v
        out.append(last)
    return out
