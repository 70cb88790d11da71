"""Declarative jobspec parsing (HCL subset)."""
from .parse import parse, parse_file, ParseError  # noqa: F401
from .hcl import loads as hcl_loads  # noqa: F401
