"""Request deadlines with an all-or-nothing commit guarantee.

A deadline is an absolute point on an injected monotonic clock. The
contract every seam honors (fleet/backend.py ``apply_changes_docs``,
fleet/sync_driver.py — both take ``deadline=``): the check runs BEFORE
the batch's fused dispatch mutates anything, so a request either fails
``DeadlineExceeded`` fully-unapplied or commits fully — never a
half-applied document. There is deliberately NO post-commit check: work
that slipped past its deadline mid-commit still commits (late useful
work beats a torn doc), and the client sees success.
"""

import time

from ..errors import DeadlineExceeded

__all__ = ['Deadline']


class Deadline:
    """An absolute deadline on a monotonic clock. ``Deadline.after(s)``
    builds one `s` seconds out; ``check(now)`` raises typed
    ``DeadlineExceeded`` once passed; ``remaining(now)`` is the budget
    left (negative = late). The clock is stored so all later checks read
    the same time source the deadline was minted from."""

    __slots__ = ('at', 'clock')

    def __init__(self, at, clock=time.monotonic):
        self.at = float(at)
        self.clock = clock

    @classmethod
    def after(cls, seconds, clock=time.monotonic):
        return cls(clock() + float(seconds), clock=clock)

    def remaining(self, now=None):
        return self.at - (self.clock() if now is None else now)

    def expired(self, now=None):
        return self.remaining(now) < 0

    def check(self, now=None, what='request'):
        late = -self.remaining(now)
        if late > 0:
            raise DeadlineExceeded(
                f'{what}: deadline exceeded by {late * 1e3:.2f}ms',
                deadline=self.at, late_by=late)
        return self

    def __repr__(self):
        return f'Deadline(at={self.at:.6f})'
