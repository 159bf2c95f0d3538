#!/usr/bin/env python
"""Render-plan conformance check of gatekeeper_tpu_torch (wired tier-1
via tests/test_torch_render_parity_tool.py; also runnable standalone):

1. Byte parity: every template in the parity corpus whose program binds a
   render plan must produce byte-identical violations (msg AND details,
   order included) to the interpreter across the adversarial resource
   set.  A plan-compiler regression fails fast here, before it could
   silently ship wrong deny messages.
2. Classification coverage: across the full corpus (parity fixtures +
   the synthetic bench families), >= 90% of template cells must classify
   to the compiled tiers (static/slots) — the interpreter fallback is
   the exception, not the rule.

The corpus is the port's copy, gatekeeper_tpu_torch/util/rendercorpus.py.
The render plans run on the host; ``--torch-device`` (default cuda) names
the device the port's drills run on, and a card asked for and missing
raises instead of running on the CPU, as every ``check_*_torch.py`` does.

Run: python tools/check_render_parity_torch.py [--torch-device cuda|cpu]
(exit 0 clean, 1 with findings)
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
COVERAGE_FLOOR = 0.9


def _corpus_modules():
    from gatekeeper_tpu_torch.util import rendercorpus

    return rendercorpus


def check_byte_parity() -> list:
    from gatekeeper_tpu_torch.engine.interp import TemplatePolicy
    from gatekeeper_tpu_torch.engine.value import freeze
    from gatekeeper_tpu_torch.ops import renderplan as rp
    from gatekeeper_tpu_torch.ops.vectorizer import vectorize

    rc = _corpus_modules()
    problems = []
    for name, template, constraint, _tier in rc.corpus():
        tgt = template["spec"]["targets"][0]
        pol = TemplatePolicy.compile(tgt["rego"], tuple(tgt.get("libs") or ()))
        plan = rp.bind(vectorize(pol), pol, constraint)
        if plan is None:
            continue
        params = freeze(constraint["spec"].get("parameters", {}))
        for obj in rc.resources():
            review = rc.review_of(obj)
            want = pol.eval_violations(freeze(review), params, freeze({}))
            got = plan.apply(rp.RowView(review))
            if got != want:
                problems.append(
                    f"render parity: {name} diverges from the interpreter "
                    f"on resource {obj['metadata'].get('name')!r}: "
                    f"plan={got!r} interp={want!r}"
                )
    return problems


def check_classification_coverage() -> list:
    from gatekeeper_tpu_torch.engine.interp import TemplatePolicy
    from gatekeeper_tpu_torch.ops import renderplan as rp
    from gatekeeper_tpu_torch.ops.vectorizer import vectorize
    from gatekeeper_tpu_torch.util.synthetic import make_templates

    rc = _corpus_modules()
    total = planned = 0
    entries = [(t, c) for _n, t, c, _tier in rc.corpus()]
    syn_templates, syn_constraints = make_templates(60)
    entries += list(zip(syn_templates, syn_constraints))
    for template, constraint in entries:
        tgt = template["spec"]["targets"][0]
        pol = TemplatePolicy.compile(tgt["rego"], tuple(tgt.get("libs") or ()))
        plan = rp.bind(vectorize(pol), pol, constraint)
        total += 1
        planned += plan is not None
    ratio = planned / total if total else 0.0
    if ratio < COVERAGE_FLOOR:
        return [
            f"render classification: only {planned}/{total} "
            f"({ratio:.1%}) of corpus templates compile to the "
            f"static/slots tiers (floor {COVERAGE_FLOOR:.0%})"
        ]
    return []


def run_checks() -> list:
    return check_byte_parity() + check_classification_coverage()


def main(argv=None) -> int:
    import argparse

    from gatekeeper_tpu_torch.device import select_device

    ap = argparse.ArgumentParser(prog="check_render_parity_torch.py")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    select_device(ap.parse_args(argv).torch_device)
    problems = run_checks()
    for p in problems:
        print(f"FINDING: {p}")
    if problems:
        print(f"{len(problems)} finding(s)")
        return 1
    print("render-plan conformance: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
