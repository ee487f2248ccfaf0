"""A whole run (the chip look skipped: ``--device cpu``) with the timed
path broken underneath, in the program, must come out not correct: one
run for each fault the cell can have (a step that leaves its state as it
was, half of each batch left out with the mean over the rest, an answer
altered where it is produced; the cells run on one chip, so there is no
exchange between chips to leave out)."""

import pytest

from bench_tiny import run_cell


def _unchanged(monkeypatch):
    import sml_tpu_torch.train.steps as steps

    def no_step(params, *args, **kw):
        st = next(a for a in args if hasattr(a, "count"))
        return st._replace(count=st.count + 1)
    monkeypatch.setattr(steps, "adam_update", no_step)
    monkeypatch.setattr(steps, "sparse_dense_adam_update", no_step)


def _half(monkeypatch):
    import sml_tpu_torch.train.steps as steps
    orig = steps.bce_pair_loss

    def half(pos, neg, mask, denom=None):
        m = mask.clone()
        m[m.shape[0] // 2:] = 0
        return orig(pos, neg, m)
    monkeypatch.setattr(steps, "bce_pair_loss", half)


def _altered_refresh(monkeypatch):
    import sml_tpu_torch.train.engine as engine
    orig = engine.apply_tables

    def altered(*a, **k):
        u, i = orig(*a, **k)
        u[0, 0] += 1.0
        return u, i
    monkeypatch.setattr(engine, "apply_tables", altered)


def _topk(change):
    def patch(monkeypatch):
        import sml_tpu_torch.eval.full_ranking as fr
        orig = fr.dense_full_topk

        def broken(*a, **k):
            s, i = orig(*a, **k)
            return change(s.clone(), i.clone())
        monkeypatch.setattr(fr, "dense_full_topk", broken)
    return patch


def _alter_id(s, i):
    i[0, 0] = (i[0, 0] + 1) % 3000
    return s, i


def _half_answers(s, i):
    h = s.shape[0] // 2
    if h:
        s[h:2 * h], i[h:2 * h] = s[:h].clone(), i[:h].clone()
    return s, i


CASES = [
    ("yelp5m1m.sweep", "sweep", _unchanged),
    ("yelp5m1m.sweep", "sweep", _half),
    ("yelp5m1m.sweep", "sweep", _altered_refresh),
    ("c5.serve", "serve", _topk(_alter_id)),
    ("c5.serve", "serve", _topk(_half_answers)),
]


@pytest.mark.parametrize("workload,kind,fault", CASES,
                         ids=["sweep-unchanged", "sweep-half",
                              "sweep-altered", "serve-altered",
                              "serve-half"])
def test_a_broken_program_is_not_correct(capsys, monkeypatch, workload,
                                         kind, fault):
    fault(monkeypatch)
    out = run_cell(capsys, workload, kind, seed=31)
    assert out["correct"] is False, out["checks"]
