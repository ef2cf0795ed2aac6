"""Host-side data pipeline (a copy of ``speechain_tpu/data``): tokenizers,
datasets keyed by ``idx2*`` metadata files, length-bucketed iterators,
epoch loaders with background prefetch."""

# import for the side effect of registering components (dataset.*,
# iterator.*, tokenizer.* names in the registry)
from speechain_tpu_torch.data import dataset as _dataset  # noqa: F401
from speechain_tpu_torch.data import iterator as _iterator  # noqa: F401
from speechain_tpu_torch.data import tokenizer as _tokenizer  # noqa: F401
