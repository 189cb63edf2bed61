"""The plain version of the ``groupby`` call: :func:`plain.groupby` over
the generated columns."""

from portbench.reference import plain


def answer(question, tables, dtype):
    return plain.groupby(tables[question["frame"]], question["by"], question["agg"], dtype)
