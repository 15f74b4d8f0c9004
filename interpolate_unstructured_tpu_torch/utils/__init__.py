"""Port subpackage; see the package docstring."""

from . import cache, config, serial_oracle, timing
