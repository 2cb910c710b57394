"""One module per contract rule; ALL_RULES is the CLI's default set."""

from .typed_errors import TypedErrorsRule
from .counter_discipline import CounterDisciplineRule
from .kernel_ledger import KernelLedgerRule
from .determinism import DeterminismRule
from .lock_discipline import LockDisciplineRule

ALL_RULES = (
    TypedErrorsRule,
    CounterDisciplineRule,
    KernelLedgerRule,
    DeterminismRule,
    LockDisciplineRule,
)

RULES_BY_ID = {cls.rule_id: cls for cls in ALL_RULES}


def get_rules(ids=None):
    """Instantiate the requested rules (all of them by default)."""
    if ids is None:
        return [cls() for cls in ALL_RULES]
    unknown = [i for i in ids if i not in RULES_BY_ID]
    if unknown:
        raise KeyError(f'unknown rule ids: {unknown}; '
                       f'known: {sorted(RULES_BY_ID)}')
    return [RULES_BY_ID[i]() for i in ids]
