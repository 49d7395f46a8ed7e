"""OpenCV-style YAML loader.

The reference stores every component configuration in OpenCV ``cv::FileStorage``
YAML files (reference: ``test/data/*.yml``, loaded at e.g.
``include/slam/frontend/feature_detector.hpp:53-107``).  Those files are almost
standard YAML except for two OpenCV-isms:

  * a ``%YAML:1.0`` directive (standard YAML spells it ``%YAML 1.0``)
  * the ``!!opencv-matrix`` tag for matrices with ``rows/cols/dt/data`` keys

This module parses them with plain PyYAML so reference config files work
unchanged, without requiring OpenCV at runtime.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import yaml


class _OpenCVLoader(yaml.SafeLoader):
    pass


def _construct_opencv_matrix(loader: _OpenCVLoader, node: yaml.Node) -> np.ndarray:
    mapping = loader.construct_mapping(node, deep=True)
    rows = int(mapping["rows"])
    cols = int(mapping["cols"])
    data = np.asarray(mapping["data"], dtype=np.float64)
    return data.reshape(rows, cols)


_OpenCVLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _construct_opencv_matrix)
# OpenCV also writes the short form "!!opencv-matrix" which PyYAML resolves to
# the tag above, but some writers emit a local "!opencv-matrix" tag.
_OpenCVLoader.add_constructor("!opencv-matrix", _construct_opencv_matrix)

_DIRECTIVE_RE = re.compile(r"^%YAML[:\s]\S+\s*$")


def load_opencv_yaml(path: str | Path) -> dict[str, Any]:
    """Load an OpenCV FileStorage YAML file into a plain dict.

    Matrices tagged ``!!opencv-matrix`` become ``np.ndarray`` (float64,
    shape ``(rows, cols)``).
    """
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Could not open config file: {path}")
    text = path.read_text()
    lines = text.splitlines()
    # Strip the non-standard %YAML:1.0 directive if present.
    if lines and _DIRECTIVE_RE.match(lines[0]):
        lines = lines[1:]
    cleaned = "\n".join(lines)
    doc = yaml.load(cleaned, Loader=_OpenCVLoader)
    if doc is None:
        return {}
    if not isinstance(doc, dict):
        raise ValueError(f"Expected a YAML mapping at top level of {path}")
    return doc
