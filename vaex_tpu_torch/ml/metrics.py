"""Model evaluation metrics through the frame's aggregations
(vaex_tpu/ml/metrics.py, ``DataFrameAccessorMetrics``).

Every metric is a mean, a sum or a groupby count over an expression of the
labels and predictions, so it runs as the frame's passes on the card (B1
for the sums and counts, B6 where a groupby probes a set); nothing copies
the columns to the host.  ``confusion_matrix`` reads the groupby's key
columns by position, so an expression works as ``y_true`` or ``y_pred``
(vaex_tpu looks them up by the expression's text and raises KeyError:
ROADMAP, known problems).
"""

from __future__ import annotations

import numpy as np


def _names(*args):
    return [str(a) for a in args]


class DataFrameAccessorMetrics:
    """``df.ml.metrics`` (vaex_tpu/ml/metrics.py:19)."""

    def __init__(self, df):
        self.df = df

    # -- classification ------------------------------------------------------
    def accuracy_score(self, y_true, y_pred, selection=None):
        """Fraction of exact matches (vaex_tpu/ml/metrics.py:26)."""
        y_true, y_pred = _names(y_true, y_pred)
        df = self.df
        return float(df.mean(f"where(({y_true}) == ({y_pred}), 1.0, 0.0)",
                             selection=selection))

    def confusion_matrix(self, y_true, y_pred, array_type=None, selection=None):
        """[n_classes, n_classes] counts, classes sorted ascending
        (vaex_tpu/ml/metrics.py:33)."""
        y_true, y_pred = _names(y_true, y_pred)
        df = self.df
        if selection is not None:
            df = df.filter(str(selection))
        classes = sorted(set(df.unique(y_true)) | set(df.unique(y_pred)))
        lut = {c: i for i, c in enumerate(classes)}
        n = len(classes)
        # the key columns by position: the groupby names an expression's
        # column after a valid name made from its text
        out = df.groupby([y_true, y_pred], agg={"__n": "count"})
        true_name, pred_name = out.get_column_names()[:2]
        C = np.zeros((n, n), np.int64)
        t = np.asarray(out[true_name].tolist())
        p = np.asarray(out[pred_name].tolist())
        c = np.asarray(out["__n"].tolist())
        for ti, pi, ci in zip(t, p, c):
            C[lut[ti], lut[pi]] = ci
        return C

    def precision_recall_fscore(self, y_true, y_pred, average="binary",
                                selection=None):
        """(precision, recall, f1) — 'binary' counts class 1 as positive,
        'macro' averages the per-class scores (vaex_tpu/ml/metrics.py:53)."""
        y_true, y_pred = _names(y_true, y_pred)
        df = self.df
        if average == "binary":
            tp = float(df.sum(f"where((({y_true}) == 1) & (({y_pred}) == 1), 1, 0)",
                              selection=selection))
            pred_pos = float(df.sum(f"where(({y_pred}) == 1, 1, 0)",
                                    selection=selection))
            true_pos = float(df.sum(f"where(({y_true}) == 1, 1, 0)",
                                    selection=selection))
            precision = tp / pred_pos if pred_pos else 0.0
            recall = tp / true_pos if true_pos else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if (precision + recall) else 0.0)
            return precision, recall, f1
        C = self.confusion_matrix(y_true, y_pred, selection=selection).astype("f8")
        with np.errstate(divide="ignore", invalid="ignore"):
            precision_array = np.diag(C) / np.sum(C, axis=0)
            recall_array = np.diag(C) / np.sum(C, axis=1)
            f1_array = 2 * (precision_array * recall_array) / (precision_array + recall_array)
        return (float(np.nanmean(precision_array)),
                float(np.nanmean(recall_array)),
                float(np.nanmean(f1_array)))

    def precision_score(self, y_true, y_pred, average="binary", selection=None):
        return self.precision_recall_fscore(y_true, y_pred, average, selection)[0]

    def recall_score(self, y_true, y_pred, average="binary", selection=None):
        return self.precision_recall_fscore(y_true, y_pred, average, selection)[1]

    def f1_score(self, y_true, y_pred, average="binary", selection=None):
        return self.precision_recall_fscore(y_true, y_pred, average, selection)[2]

    def matthews_correlation_coefficient(self, y_true, y_pred, selection=None):
        """MCC from the confusion matrix (vaex_tpu/ml/metrics.py:89; the
        multi-class generalization, as sklearn's)."""
        C = self.confusion_matrix(y_true, y_pred, selection=selection).astype("f8")
        t_sum = C.sum(axis=1)
        p_sum = C.sum(axis=0)
        n = C.sum()
        correct = np.trace(C)
        cov_ytyp = correct * n - np.dot(t_sum, p_sum)
        cov_ypyp = n * n - np.dot(p_sum, p_sum)
        cov_ytyt = n * n - np.dot(t_sum, t_sum)
        denom = np.sqrt(cov_ytyt * cov_ypyp)
        return float(cov_ytyp / denom) if denom else 0.0

    def classification_report(self, y_true, y_pred, average="binary", decimals=3):
        """Text report: accuracy/precision/recall/f1 (vaex_tpu/ml/metrics.py:103)."""
        acc = self.accuracy_score(y_true, y_pred)
        p, r, f = self.precision_recall_fscore(y_true, y_pred, average=average)
        fmt = f"%.{decimals}f"
        return ("\n        Classification report:\n\n"
                f"        Accuracy:  {fmt % acc}\n"
                f"        Precision: {fmt % p}\n"
                f"        Recall:    {fmt % r}\n"
                f"        F1:        {fmt % f}\n        ")

    # -- regression ----------------------------------------------------------
    def mean_absolute_error(self, y_true, y_pred, selection=None):
        y_true, y_pred = _names(y_true, y_pred)
        return float(self.df.mean(f"abs(({y_true}) - ({y_pred}))",
                                  selection=selection))

    def mean_squared_error(self, y_true, y_pred, selection=None):
        y_true, y_pred = _names(y_true, y_pred)
        return float(self.df.mean(f"(({y_true}) - ({y_pred}))**2",
                                  selection=selection))

    def r2_score(self, y_true, y_pred, selection=None):
        """1 - SS_res / SS_tot (vaex_tpu/ml/metrics.py:126)."""
        y_true, y_pred = _names(y_true, y_pred)
        df = self.df
        ss_res = float(df.sum(f"(({y_true}) - ({y_pred}))**2", selection=selection))
        mean_true = float(df.mean(y_true, selection=selection))
        ss_tot = float(df.sum(f"(({y_true}) - {mean_true!r})**2",
                              selection=selection))
        return 1.0 - ss_res / ss_tot if ss_tot else 0.0
