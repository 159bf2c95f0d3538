"""Direct tests for gatekeeper_tpu_torch/deadline.py: the
module is load-bearing for every admission request.  Covers zero/negative budgets, nested budget() scopes
restoring the outer deadline, remaining() after expiry, and the
budget-derivation helpers (min() semantics, header and
timeoutSeconds parsing).

The port's copy of tests/test_deadline.py, on gatekeeper_tpu_torch."""

import threading
import time

import pytest

from gatekeeper_tpu_torch import deadline as dl


class TestPushPop:
    def test_no_deadline_by_default(self):
        assert dl.current() is None
        assert dl.remaining() is None
        assert dl.remaining_ms() is None
        assert dl.expired() is False

    def test_push_sets_absolute_deadline(self):
        token = dl.push(10.0)
        try:
            assert dl.current() is not None
            rem = dl.remaining()
            assert 9.0 < rem <= 10.0
            assert not dl.expired()
        finally:
            dl.pop(token)
        assert dl.current() is None

    def test_zero_budget_is_immediately_expired(self):
        token = dl.push(0.0)
        try:
            # remaining() may be exactly 0 at the boundary but goes
            # negative immediately; expired() uses strict >
            time.sleep(0.001)
            assert dl.expired()
            assert dl.remaining() <= 0
        finally:
            dl.pop(token)

    def test_negative_budget_is_immediately_expired(self):
        token = dl.push(-1.0)
        try:
            assert dl.expired()
            rem = dl.remaining()
            assert rem < 0
            # two separate clock reads: compare loosely
            assert dl.remaining_ms() == pytest.approx(rem * 1e3, abs=50)
        finally:
            dl.pop(token)

    def test_remaining_after_expiry_goes_negative_not_none(self):
        """remaining() after expiry must report the (negative) deficit —
        a proxy forwarding max(remaining, 0) depends on it being a
        number, not None."""
        with dl.budget(0.005):
            time.sleep(0.02)
            rem = dl.remaining()
            assert rem is not None and rem < 0
            assert dl.expired()


class TestBudgetScopes:
    def test_nested_scopes_restore_the_outer_deadline(self):
        with dl.budget(60.0):
            outer = dl.current()
            with dl.budget(1.0):
                inner = dl.current()
                assert inner < outer  # tighter inner deadline
            assert dl.current() == outer  # outer restored exactly
        assert dl.current() is None

    def test_nested_scope_may_be_looser_but_restores(self):
        # the scopes are independent pushes, not min()-merged: an inner
        # budget() REPLACES the deadline for its extent (callers that
        # want the min use effective_budget_s at derivation time)
        with dl.budget(0.5):
            outer = dl.current()
            with dl.budget(120.0):
                assert dl.current() > outer
            assert dl.current() == outer

    def test_scope_restores_on_exception(self):
        with pytest.raises(RuntimeError):
            with dl.budget(30.0):
                raise RuntimeError("boom")
        assert dl.current() is None

    def test_deadline_is_thread_local(self):
        seen = {}

        def other():
            seen["other"] = dl.current()

        with dl.budget(30.0):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=5.0)
        assert seen["other"] is None


class TestEffectiveBudget:
    def test_all_absent_means_no_deadline(self):
        assert dl.effective_budget_s(None, None, None) is None
        assert dl.effective_budget_s() is None

    def test_min_semantics(self):
        assert dl.effective_budget_s(0.5, 10.0) == 0.5
        assert dl.effective_budget_s(10.0, 0.5) == 0.5
        assert dl.effective_budget_s(None, 3.0, 2.0) == 2.0

    def test_zero_and_negative_candidates_are_preserved(self):
        # an exhausted budget must surface as exhausted, not be clamped
        # into a fabricated allowance
        assert dl.effective_budget_s(10.0, 0.0) == 0.0
        assert dl.effective_budget_s(10.0, -0.2) == -0.2


class TestWireParsing:
    def test_header_ms_parses_to_seconds(self):
        assert dl.parse_header_ms("250") == 0.25
        assert dl.parse_header_ms("82.5") == pytest.approx(0.0825)
        assert dl.parse_header_ms("-5") == -0.005

    def test_header_malformed_is_no_bound(self):
        assert dl.parse_header_ms(None) is None
        assert dl.parse_header_ms("") is None
        assert dl.parse_header_ms("soon") is None

    def test_non_finite_values_are_no_bound(self):
        # NaN compares False against everything (an expired check would
        # never fire) and settimeout(nan) raises mid-proxy — neither
        # NaN nor infinity is a budget, from either source
        assert dl.parse_header_ms("nan") is None
        assert dl.parse_header_ms("inf") is None
        assert dl.parse_header_ms("-inf") is None
        assert dl.parse_timeout_seconds(
            {"timeoutSeconds": float("nan")}) is None
        assert dl.parse_timeout_seconds(
            {"timeoutSeconds": float("inf")}) is None

    def test_timeout_seconds(self):
        assert dl.parse_timeout_seconds({"timeoutSeconds": 10}) == 10.0
        assert dl.parse_timeout_seconds({"timeoutSeconds": 2.5}) == 2.5
        assert dl.parse_timeout_seconds({}) is None
        assert dl.parse_timeout_seconds({"timeoutSeconds": "10"}) is None
        # True is an int in Python; a boolean is corruption, not 1s
        assert dl.parse_timeout_seconds({"timeoutSeconds": True}) is None
        assert dl.parse_timeout_seconds(None) is None
