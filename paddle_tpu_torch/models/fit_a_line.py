"""fit_a_line (counterpart of ``paddle_tpu.models.fit_a_line``; the first
book chapter, tests/book/test_fit_a_line.py): linear regression on UCI
housing, 13 features to a price, square error cost."""

from __future__ import annotations

from .. import layers


def make_model():
    def fit_a_line(x, y):
        """x: [b, 13] float features; y: [b, 1] float prices."""
        y_predict = layers.fc(x, 1, name="fc")
        avg_cost = layers.mean(layers.square_error_cost(y_predict, y))
        return {"loss": avg_cost, "pred": y_predict}

    return fit_a_line


__all__ = ["make_model"]
