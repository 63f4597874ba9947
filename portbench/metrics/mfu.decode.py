"""The published model's operations (2 x parameters a token, the lm_head
for tokens that project onto the vocabulary, plus attention) for the
window's tokens, over the window at the H100's bf16 peak."""
import readers


def read(run):
    return readers.mfu(run)
