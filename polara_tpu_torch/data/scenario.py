"""Evaluation-scenario state machine (copy of
:mod:`polara_tpu.data.scenario`).

Re-implementation of the reference's transition logic
(``polara/recommender/data.py:275-385``) as a standalone pure function so it
can be unit-tested exhaustively over all (state x change-set) combinations.

Five scenarios are distinguished by the split configuration:

========  ===========================================  ======================
state     meaning                                      config signature
========  ===========================================  ======================
1         training only, nothing held out              hsz == 0, trt == 0
11        user fold reserved, no holdout               hsz == 0, trt > 0
2         per-user holdout sampled from all users      hsz != 0, trt == 0
3         holdout sampled from known (seen) users      hsz != 0, trt > 0
4         warm start: test users unseen in training    hsz != 0, trt > 0, ws
========  ===========================================  ======================

A config change maps to one of three outcomes: no action, ``test_update``
(only the holdout/testset needs resampling — models can keep factors and just
re-predict) or ``full_update`` (training data changed — models must rebuild).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import FrozenSet, Optional, Tuple


class Scenario(IntEnum):
    TRAIN_ONLY = 1
    TESTSET_ONLY = 11
    HOLDOUT_ONLY = 2
    KNOWN_USERS = 3
    WARM_START = 4


@dataclass(frozen=True)
class UpdateRule:
    full_update: bool = False
    test_update: bool = False

    @property
    def any(self) -> bool:
        return self.full_update or self.test_update


FULL = UpdateRule(full_update=True)
TEST = UpdateRule(test_update=True)
NOOP = UpdateRule()


def plan_update(last_state: Optional[int],
                changed: FrozenSet[str],
                holdout_size: float,
                test_ratio: float,
                warm_start: bool,
                random_holdout: bool) -> Tuple[Optional[int], UpdateRule]:
    """Decide the next scenario state and the kind of re-split required.

    ``changed`` holds external config-property names modified since the last
    split (plus the sentinel ``'init'`` on a fresh instance).
    """
    test_data_change = bool({"test_ratio", "test_fold"} & changed)
    test_sample_change = "test_sample" in changed
    holdout_change = (
        "holdout_size" in changed
        or "random_holdout" in changed
        or "permute_tops" in changed
        or ("negative_prediction" in changed and not random_holdout)
    )
    no_holdout = holdout_size == 0
    no_testset = test_ratio == 0

    def settled_state() -> int:
        if no_holdout:
            return Scenario.TRAIN_ONLY if no_testset else Scenario.TESTSET_ONLY
        if no_testset:
            return Scenario.HOLDOUT_ONLY
        return Scenario.WARM_START if warm_start else Scenario.KNOWN_USERS

    if "warm_start" in changed:
        # toggling warm_start redefines what "test user" means
        if warm_start:
            if last_state == Scenario.TESTSET_ONLY and not test_data_change:
                # the reserved user fold stays as is; only holdout is sampled
                return Scenario.WARM_START, TEST
            return Scenario.WARM_START, FULL
        nxt = settled_state()
        if (nxt == Scenario.TESTSET_ONLY and not test_data_change
                and last_state is not None):
            # the reserved fold is unchanged; only test data shrinks
            return nxt, TEST
        return nxt, FULL

    if last_state is None:  # first ever split
        return settled_state(), FULL

    if last_state == Scenario.TRAIN_ONLY:
        if "holdout_size" in changed and not no_holdout:
            nxt = (Scenario.KNOWN_USERS if "test_ratio" in changed
                   else Scenario.HOLDOUT_ONLY)
            return nxt, FULL
        if "test_ratio" in changed and not no_testset:
            return Scenario.TESTSET_ONLY, FULL
        return last_state, NOOP

    if last_state == Scenario.TESTSET_ONLY:
        if "holdout_size" in changed and not no_holdout:
            nxt = Scenario.HOLDOUT_ONLY if no_testset else Scenario.KNOWN_USERS
            return nxt, FULL
        if test_data_change:
            return (Scenario.TRAIN_ONLY if no_testset else last_state), FULL
        return last_state, NOOP

    if last_state == Scenario.HOLDOUT_ONLY:
        if "test_ratio" in changed and not no_testset:
            nxt = (Scenario.TESTSET_ONLY if no_holdout
                   else Scenario.KNOWN_USERS)
            return nxt, FULL
        if holdout_change:
            return (Scenario.TRAIN_ONLY if no_holdout else last_state), FULL
        return last_state, NOOP

    if last_state == Scenario.KNOWN_USERS:
        if test_data_change or holdout_change:
            if no_holdout:
                nxt = (Scenario.TRAIN_ONLY if no_testset
                       else Scenario.TESTSET_ONLY)
            elif no_testset:
                nxt = Scenario.HOLDOUT_ONLY
            else:
                nxt = last_state
            return nxt, FULL
        return last_state, NOOP

    if last_state == Scenario.WARM_START:
        if holdout_change:
            if no_holdout:
                if test_data_change:
                    nxt = (Scenario.TRAIN_ONLY if no_testset
                           else Scenario.TESTSET_ONLY)
                    return nxt, FULL
                # dropping the holdout while keeping the reserved fold:
                # training set is unchanged, only test data shrinks
                return Scenario.TESTSET_ONLY, TEST
            if test_data_change:
                nxt = Scenario.HOLDOUT_ONLY if no_testset else last_state
                return nxt, FULL
            return last_state, TEST  # includes test_sample changes
        if test_data_change:
            nxt = Scenario.HOLDOUT_ONLY if no_testset else last_state
            return nxt, FULL
        if test_sample_change:
            return last_state, TEST
        return last_state, NOOP

    raise ValueError(f"Unknown scenario state: {last_state}")


def validate_config(holdout_size: float, test_ratio: float,
                    test_fold: int, warm_start: bool) -> None:
    """Invariants between config values (reference ``data.py:261-272``)."""
    if warm_start and not (holdout_size and test_ratio):
        raise ValueError("warm_start requires positive holdout_size and "
                         "test_ratio")
    if not warm_start and holdout_size == 0 and test_ratio > 0:
        raise ValueError("test_ratio must be 0 when holdout_size is 0 and "
                         "warm_start is False")
    if test_ratio >= 1:
        raise ValueError("test_ratio must be below 1")
    if test_ratio and test_fold > 1.0 / test_ratio:
        raise ValueError(f"test_fold cannot exceed {1.0 / test_ratio}")
