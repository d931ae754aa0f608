"""The port's space lint (``hyperopt_tpu_torch.analysis``) against the JAX
package's: every space-lint case of ``tests/test_analysis.py`` (the golden
corpus, garbage input, suppression, shared nodes and nested paths, the
zoo's domains, the constructors' checks, the report shape and the
``fmin(validate_space=True)`` pre-flight) run through both packages on the
same space.  Each case's rule ids, severities, locations, messages and
hints equal the JAX package's; the pre-flight raises before any suggest."""

from functools import partial

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import analysis as jan
from hyperopt_tpu.pyll.base import scope as jscope
from hyperopt_tpu_torch import analysis as tan
from hyperopt_tpu_torch.analysis.diagnostics import RULES
from hyperopt_tpu_torch.pyll.base import scope as tscope

PKGS = {"jax": (J.hp, jscope, jan.lint_space), "torch": (T.hp, tscope, tan.lint_space)}


def _raw(scope, label, dist, *args):
    """A hyperparameter node built through raw scope composition, past the
    ``hp.*`` construction-time checks (the reference test's ``_raw``)."""
    wrap = scope.int if dist in ("uniformint",) else scope.float
    return wrap(scope.hyperopt_param(label, getattr(scope, dist)(*args)))


def _rows(diags):
    return sorted((d.rule, d.severity, d.location, d.message, d.hint) for d in diags)


def both(build, **kw):
    """(JAX rows, port rows) of ``build(hp, scope)`` linted in each package."""
    out = []
    for hp, scope, lint in PKGS.values():
        out.append(_rows(lint(build(hp, scope), **kw)))
    return out


SPACE_CORPUS = [
    # (name, space builder (hp, scope), expected rule ids (sorted)) — the
    # reference's SPACE_CORPUS (tests/test_analysis.py)
    ("inverted_uniform",
     lambda hp, s: {"x": _raw(s, "x", "uniform", 5.0, 1.0)}, ["SP102"]),
    ("inverted_loguniform",
     lambda hp, s: {"x": _raw(s, "x", "loguniform", 2.0, -2.0)}, ["SP102"]),
    ("negative_q",
     lambda hp, s: {"x": _raw(s, "x", "quniform", 0.0, 10.0, -1.0)}, ["SP103"]),
    ("zero_sigma_normal",
     lambda hp, s: {"x": _raw(s, "x", "normal", 0.0, 0.0)}, ["SP104"]),
    ("negative_sigma_lognormal",
     lambda hp, s: {"x": _raw(s, "x", "lognormal", 0.0, -2.0)}, ["SP104"]),
    ("loguniform_overflow",
     lambda hp, s: {"x": _raw(s, "x", "loguniform", 0.0, 100.0)}, ["SP105"]),
    ("loguniform_underflow",
     lambda hp, s: {"x": _raw(s, "x", "loguniform", -120.0, 1.0)}, ["SP106"]),
    ("duplicate_across_dict",
     lambda hp, s: {"a": hp.uniform("x", 0, 1), "b": hp.uniform("x", 0, 1)},
     ["SP101"]),
    ("duplicate_across_branches_raw",
     lambda hp, s: s.switch(
         s.hyperopt_param("m", s.randint(2)),
         {"lr": _raw(s, "lr", "uniform", 0.0, 1.0)},
         {"lr": _raw(s, "lr", "uniform", 5.0, 9.0)},
     ),
     ["SP101"]),
    ("pchoice_dead_branch",
     lambda hp, s: hp.pchoice("f", [(0.0, "off"), (1.0, "on")]), ["SP107"]),
    ("single_option_choice",
     lambda hp, s: {"c": hp.choice("c", ["only"])}, ["SP107"]),
    ("uniformint_fractional_q",
     lambda hp, s: {"x": _raw(s, "x", "uniformint", 0.0, 9.0, 1.5)}, ["SP108"]),
    ("quniform_span_not_multiple",
     lambda hp, s: {"x": hp.quniform("x", 0.0, 10.0, 3.0)}, ["SP108"]),
    ("randint_empty_range",
     lambda hp, s: {"x": s.hyperopt_param("x", s.randint(7, 3))}, ["SP102"]),
    ("randint_fractional_bounds",
     lambda hp, s: {"x": s.hyperopt_param("x", s.randint(1.5, 7.0))}, ["SP108"]),
    ("inverted_and_overflow_combo",
     lambda hp, s: {
         "a": _raw(s, "a", "uniform", 3.0, 3.0),
         "b": _raw(s, "b", "loguniform", -1.0, 200.0),
     },
     ["SP102", "SP105"]),
]


@pytest.mark.parametrize("name,build,expected", SPACE_CORPUS,
                         ids=[c[0] for c in SPACE_CORPUS])
def test_space_corpus_golden_equals_jax(name, build, expected):
    jrows, trows = both(build)
    assert trows == jrows, name
    assert sorted(r[0] for r in trows) == expected
    for rule, severity, location, message, _ in trows:
        assert severity == RULES[rule].severity and location and message


def test_space_lint_never_raises_on_garbage():
    class Weird:
        pass

    assert tan.lint_space({"x": T.hp.uniform("x", 0, 1), "y": 3, "z": "s"}) == []
    for garbage in (Weird(), None, [1, "a", None]):
        got = tan.lint_space(garbage)
        assert isinstance(got, list)
        assert _rows(got) == _rows(jan.lint_space(garbage))


def test_space_lint_suppression():
    def build(hp, s):
        return {"x": _raw(s, "x", "uniform", 5.0, 1.0)}

    jrows, trows = both(build)
    assert trows == jrows and [r[0] for r in trows] == ["SP102"]
    assert both(build, suppress=("SP102",)) == [[], []]


def test_shared_node_across_branches_is_not_duplicate():
    def build(hp, s):
        shared = hp.uniform("lr", 0, 1)
        return hp.choice("m", [{"lr": shared}, {"lr": shared, "e": hp.uniform("e", 0, 1)}])

    assert both(build) == [[], []]


def test_nested_choice_paths_in_duplicate_message():
    def build(hp, s):
        return s.switch(
            s.hyperopt_param("outer", s.randint(2)),
            {"lr": _raw(s, "lr", "uniform", 0.0, 1.0)},
            s.switch(
                s.hyperopt_param("inner", s.randint(2)),
                {"lr": _raw(s, "lr", "uniform", 5.0, 9.0)},
                0,
            ),
        )

    jrows, trows = both(build)
    assert trows == jrows
    (sp101,) = [r for r in trows if r[0] == "SP101"]
    assert "choice['outer'][0]" in sp101[2] and "choice['inner'][0]" in sp101[2]


@pytest.mark.parametrize("name", ["quadratic1", "branin", "gauss_wave2", "hartmann6"])
def test_quality_domains_zero_diagnostics(name):
    """The QUALITY.md domains of the port's model zoo lint clean, as the
    JAX package's do."""
    from hyperopt_tpu.models import domains as jdomains
    from hyperopt_tpu_torch.models import domains as tdomains

    assert tan.lint_space(tdomains.get(name).space) == []
    assert jan.lint_space(jdomains.get(name).space) == []


@pytest.mark.parametrize("build", [
    lambda hp: hp.uniform("x", 5, 1),
    lambda hp: hp.quniform("x", 0, 10, 0),
    lambda hp: hp.uniformint("x", 3, 3),
    lambda hp: hp.loguniform("x", 1.0, 1.0),
    lambda hp: hp.qloguniform("x", 0, 1, -2),
    lambda hp: hp.normal("x", 0, 0),
    lambda hp: hp.qnormal("x", 0, -1, 1),
    lambda hp: hp.lognormal("x", 0, 0),
    lambda hp: hp.qlognormal("x", 0, 1, 0),
    lambda hp: hp.randint("x", 0),
    lambda hp: hp.randint("x", 8, 3),
])
def test_constructors_raise_invalid_space(build):
    messages = []
    for hp, exc in ((J.hp, J.InvalidSpaceError), (T.hp, T.InvalidSpaceError)):
        with pytest.raises(exc) as ei:
            build(hp)
        assert ei.value.label == "x"
        messages.append(str(ei.value))
    assert messages[0] == messages[1]


def test_diagnostic_model_report_shape():
    def build(hp, s):
        return {"x": _raw(s, "x", "loguniform", 0.0, 100.0)}

    jd = jan.lint_space(build(J.hp, jscope))
    td = tan.lint_space(build(T.hp, tscope))
    assert tan.has_errors(td) and jan.diagnostics.has_errors(jd)
    rep = tan.format_report(td, header="hdr")
    assert rep == jan.format_report(jd, header="hdr")
    assert rep.startswith("hdr") and "SP105" in rep and "hint:" in rep
    # the machine-readable rows (the reference's diagnostics_json) agree
    # too, and a graph-path location keeps line None
    rows = jan.diagnostics_json(td)
    assert rows == jan.diagnostics_json(jd) and rows[0]["line"] is None


def _fmin_args(pkg):
    if pkg is T:
        return dict(algo=partial(T.rand.suggest, device="cpu"))
    return dict(algo=J.rand.suggest)


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_fmin_validate_space_preflight(pkg):
    """An SP error raises InvalidSpaceError before the first suggest: the
    algorithm is never called; the findings ride the exception and equal
    the other package's."""
    calls = []

    def algo(*a, **kw):
        calls.append(a)
        return _fmin_args(pkg)["algo"](*a, **kw)

    scope = tscope if pkg is T else jscope
    bad = {"x": _raw(scope, "x", "uniform", 5.0, 1.0)}
    with pytest.raises(pkg.InvalidSpaceError) as ei:
        pkg.fmin(lambda c: c["x"], bad, algo=algo, max_evals=3, trials=pkg.Trials(),
                 rstate=np.random.default_rng(0), show_progressbar=False,
                 verbose=False, validate_space=True)
    assert calls == []
    assert any(d.rule == "SP102" for d in ei.value.diagnostics)
    other = jscope if pkg is T else tscope
    lint = jan.lint_space if pkg is T else tan.lint_space
    assert _rows(ei.value.diagnostics) == _rows(
        lint({"x": _raw(other, "x", "uniform", 5.0, 1.0)}))


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_fmin_validate_space_passes_good_space(pkg, caplog):
    """A clean space runs; a warning-only space runs too, its findings
    logged (SP108: a quniform span that is not a multiple of q)."""
    for space in ({"x": pkg.hp.uniform("x", -1, 1)},
                  {"x": pkg.hp.quniform("x", 0.0, 10.0, 3.0)}):
        best = pkg.fmin(lambda c: c["x"] ** 2, space, max_evals=3, trials=pkg.Trials(),
                        rstate=np.random.default_rng(0), show_progressbar=False,
                        verbose=False, validate_space=True, **_fmin_args(pkg))
        assert "x" in best
    assert any("SP108" in r.getMessage() for r in caplog.records)
