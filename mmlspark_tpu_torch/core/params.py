"""Param system: typed, documented, serializable stage configuration.

Reference: `core/contracts/src/main/scala/Params.scala:12-137` (shared param
traits HasInputCol/HasOutputCol/HasLabelCol/...), Spark ML `Param`/`Params`,
and the scalar-or-column `ServiceParam` semantics of
`io/http/src/main/scala/CognitiveServiceBase.scala:25-148`.

A copy of mmlspark_tpu/core/params.py: params are plain descriptors on Python classes — no
reflection over JVMs, no codegen. The same classes ARE the Python API
(reference layer L7 collapses: Python is the host language), and a global
registry (serialize.py) makes every stage enumerable for fuzzing, playing
the role of `JarLoadingUtils` + `FuzzingTest.scala:27-100`.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = [
    "Param",
    "ServiceParam",
    "Params",
    "HasInputCol",
    "HasOutputCol",
    "HasInputCols",
    "HasOutputCols",
    "HasLabelCol",
    "HasFeaturesCol",
    "HasWeightCol",
    "HasPredictionCol",
    "HasScoresCol",
    "HasScoredLabelsCol",
    "HasScoredProbabilitiesCol",
    "HasEvaluationMetric",
    "HasSeed",
    "HasBatchSize",
]


class Param:
    """A typed parameter descriptor attached to a Params subclass."""

    def __init__(
        self,
        default: Any = None,
        doc: str = "",
        *,
        required: bool = False,
        validator: Callable[[Any], bool] | None = None,
        ptype: type | tuple[type, ...] | None = None,
    ):
        self.default = default
        self.doc = doc
        self.required = required
        self.validator = validator
        self.ptype = ptype
        self.name: str = ""  # filled by __set_name__

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def validate(self, value: Any) -> None:
        if value is None:
            return
        if self.ptype is not None and not isinstance(value, self.ptype):
            # allow ints where floats are expected
            if not (self.ptype in (float, (float,)) and isinstance(value, int)):
                raise TypeError(
                    f"param {self.name!r} expects {self.ptype}, got {type(value).__name__}"
                )
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"param {self.name!r}: invalid value {value!r}")

    # descriptor protocol: instances read from the object's param dict
    def __get__(self, obj: Any, objtype: type | None = None) -> Any:
        if obj is None:
            return self
        return obj.get(self.name)

    def __set__(self, obj: Any, value: Any) -> None:
        obj.set(**{self.name: value})


class ServiceParam(Param):
    """Scalar-or-column param (reference `ServiceParam`,
    CognitiveServiceBase.scala:25-148): value may be a literal applied to all
    rows or the name of a column supplying per-row values.

    Set literal via ``stage.set(p=value)``; set column via
    ``stage.set_col(p="colname")``. `resolve(table)` yields per-row values.
    """

    def resolve(self, stage: "Params", table) -> list[Any] | None:
        colname = stage._vector_cols.get(self.name)
        if colname is not None:
            col = table[colname]
            return list(col)
        val = stage.get(self.name)
        if val is None:
            return None
        return [val] * table.num_rows


class _ParamsMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        params: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    params[k] = v
        cls._params = params
        return cls


class Params(metaclass=_ParamsMeta):
    """Base for everything configurable. Holds values; defaults live on the
    descriptors. `set` returns self for chaining (fluent API, reference
    `FluentAPI.scala:13-30`)."""

    _params: dict[str, Param]

    def __init__(self, **kwargs: Any):
        self._values: dict[str, Any] = {}
        self._vector_cols: dict[str, str] = {}  # ServiceParam column bindings
        if kwargs:
            self.set(**kwargs)

    # -- get/set -----------------------------------------------------------
    def get(self, name: str) -> Any:
        if name not in self._params:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        if name in self._values:
            return self._values[name]
        return self._params[name].default

    def is_set(self, name: str) -> bool:
        return name in self._values

    def set(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            if name not in self._params:
                raise KeyError(f"{type(self).__name__} has no param {name!r}")
            self._params[name].validate(value)
            self._values[name] = value
        return self

    def set_col(self, **kwargs: str) -> "Params":
        """Bind ServiceParams to columns (per-row values)."""
        for name, col in kwargs.items():
            p = self._params.get(name)
            if not isinstance(p, ServiceParam):
                raise KeyError(f"{name!r} is not a ServiceParam of {type(self).__name__}")
            self._vector_cols[name] = col
        return self

    def resolve(self, name: str, table) -> list[Any] | None:
        p = self._params.get(name)
        if not isinstance(p, ServiceParam):
            raise KeyError(f"{name!r} is not a ServiceParam")
        return p.resolve(self, table)

    # -- introspection / copy / serialization ------------------------------
    @classmethod
    def param_names(cls) -> list[str]:
        return list(cls._params)

    def explain_params(self) -> str:
        lines = []
        for name, p in self._params.items():
            cur = self.get(name)
            lines.append(f"{name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    def copy(self, extra: dict[str, Any] | None = None) -> "Params":
        out = type(self).__new__(type(self))
        out.__dict__.update({k: v for k, v in self.__dict__.items()})
        out._values = dict(self._values)
        out._vector_cols = dict(self._vector_cols)
        if extra:
            out.set(**extra)
        return out

    def params_to_dict(self) -> dict[str, Any]:
        """JSON-able params only; complex values handled by serialize.py."""
        return dict(self._values)

    def _check_required(self) -> None:
        for name, p in self._params.items():
            if p.required and self.get(name) is None and name not in self._vector_cols:
                raise ValueError(
                    f"{type(self).__name__}: required param {name!r} is not set"
                )

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"{type(self).__name__}({kv})"


# -- shared column-role mixins (reference Params.scala:12-137) -------------
class HasInputCol(Params):
    input_col = Param("input", "name of the input column", ptype=str)


class HasOutputCol(Params):
    output_col = Param("output", "name of the output column", ptype=str)


class HasInputCols(Params):
    input_cols = Param(None, "names of the input columns", ptype=(list, tuple))


class HasOutputCols(Params):
    output_cols = Param(None, "names of the output columns", ptype=(list, tuple))


class HasLabelCol(Params):
    label_col = Param("label", "name of the label column", ptype=str)


class HasFeaturesCol(Params):
    features_col = Param("features", "name of the features column", ptype=str)


class HasWeightCol(Params):
    weight_col = Param(None, "name of the instance-weight column", ptype=str)


class HasPredictionCol(Params):
    prediction_col = Param("prediction", "name of the prediction column", ptype=str)


class HasScoresCol(Params):
    scores_col = Param("scores", "name of the raw-scores column", ptype=str)


class HasScoredLabelsCol(Params):
    scored_labels_col = Param("scored_labels", "name of the scored-labels column", ptype=str)


class HasScoredProbabilitiesCol(Params):
    scored_probabilities_col = Param(
        "scored_probabilities", "name of the scored-probabilities column", ptype=str
    )


class HasEvaluationMetric(Params):
    evaluation_metric = Param("all", "metric to evaluate/optimize", ptype=str)


class HasSeed(Params):
    seed = Param(0, "random seed", ptype=int)


class HasBatchSize(Params):
    batch_size = Param(None, "mini-batch size (None = whole table)", ptype=int)
