"""Dataset loaders (wikitext2 / ptb / c4, local first) and the synthetic
stand-in."""

from .loaders import CalibSample, TokenizedText, get_loaders  # noqa: F401
