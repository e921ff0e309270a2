"""Importing a reader of the program's spans (``metrics/_spans.py``)
switches the spans on for the whole process, as a traced run needs; each
test here switches them off again when it ends, so none leaves them on
for the tests after it."""

import pytest

from multimodal_context_reasoning_torch.utils import profiling


@pytest.fixture(autouse=True)
def spans_off_after():
    yield
    profiling.enable_spans(False)
