from repro_torch.roofline.analysis import (  # noqa: F401
    roofline_terms,
    summarize_cell,
)
