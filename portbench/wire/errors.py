"""The typed wire errors the frozen codec raises (a frozen subset of
automerge_tpu_torch/errors.py:76-110 and :257-268)."""


class AutomergeError(Exception):
    def __init__(self, message='', doc_index=None):
        super().__init__(message)
        self.doc_index = doc_index


class WireCorruption(AutomergeError, ValueError):
    """Bytes that do not decode."""


class MalformedChange(WireCorruption):
    """A change chunk that does not decode."""


class MalformedDocument(WireCorruption):
    """A document chunk that does not decode."""


class MalformedSyncMessage(WireCorruption):
    """A sync message that does not decode."""


def as_wire_error(exc, err_cls, what, doc_index=None):
    """Normalize an arbitrary decoder exception into the typed class."""
    if isinstance(exc, AutomergeError):
        if doc_index is not None and exc.doc_index is None:
            exc.doc_index = doc_index
        return exc
    err = err_cls(f'{what}: {type(exc).__name__}: {exc}',
                  doc_index=doc_index)
    err.__cause__ = exc
    return err
