"""Session history managers for the eager baseline.

Copy of ``lmdeploy_tpu/pytorch/session.py``.  Reference: lmdeploy/pytorch/session.py — BasicSessionManager (no
history) and BasicSessionManagerWithHistory (rolling window bounded by
max_session_len, trimmed by reduce_size)."""
from __future__ import annotations


class BasicSessionManager:
    """Stateless: every turn stands alone."""

    def prepend_history(self, input_ids):
        return input_ids

    def add_to_history(self, output_ids):
        pass

    def new_session(self):
        pass


class BasicSessionManagerWithHistory:
    """Keeps token history, trimming from the front when the session
    exceeds max_session_len (reference drops reduce_size tokens)."""

    def __init__(self, max_session_len: int = 2048,
                 reduce_size: int = 256):
        assert max_session_len > reduce_size >= 0
        self.max_session_len = max_session_len
        self.reduce_size = reduce_size
        self.history = []

    def new_session(self):
        self.history = []

    def prepend_history(self, input_ids):
        ids = self.history + list(input_ids)
        if len(ids) > self.max_session_len:
            ids = ids[-(self.max_session_len - self.reduce_size):]
        self.history = ids
        return ids

    def add_to_history(self, output_ids):
        self.history = self.history + list(output_ids)


__all__ = ['BasicSessionManager', 'BasicSessionManagerWithHistory']
