"""``df.groupby(by, agg=...)``: ``by`` is a key or a list of keys, ``agg``
is {output: aggregator}; an aggregator is a string (``"sum"``,
``"count"``: of the column of its name) or
``[function of vaex_tpu_torch.agg, *arguments, {keywords}]``.  The answer
is a frame with a row a group, in any order; its keys order it."""

import numpy as np
import torch


def aggregator(vt, spec):
    if isinstance(spec, str):
        return spec
    fn, *args = spec
    kwargs = args.pop() if args and isinstance(args[-1], dict) else {}
    return getattr(vt.agg, fn)(*args, **kwargs)


def ask(vt, question, frames):
    agg = {name: aggregator(vt, spec) for name, spec in question["agg"].items()}
    return frames[question["frame"]].groupby(question["by"], agg=agg)


def keys(question):
    by = question["by"]
    return [by] if isinstance(by, str) else list(by)


def got(answer, question):
    """{column: tensor}: the answer's columns, where the program left them."""
    out = {}
    for name in answer.get_column_names():
        col = answer.dataset[name]
        out[name] = (col if isinstance(col, torch.Tensor)
                     else torch.as_tensor(np.array(answer[name].values)))
    return out
