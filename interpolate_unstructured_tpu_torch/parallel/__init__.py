"""Port subpackage; see the package docstring."""

from . import sharding
