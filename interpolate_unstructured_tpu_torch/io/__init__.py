"""Port subpackage; see the package docstring."""

from . import binda, convert, vtk, vtu
from . import checkpoint
