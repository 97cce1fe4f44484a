from tidb_tpu_torch.parser.parser import ParseError, parse, parse_one
from tidb_tpu_torch.parser import ast

__all__ = ["parse", "parse_one", "ParseError", "ast"]
