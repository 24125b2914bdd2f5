"""Problem configuration loading.

Copy of ``reconplan_tpu.io.config`` (stdlib and numpy only). Loads
``data/problems/<robot>/<type>.json``: robot_class, domain,
rotation_domain, fixed_rotation, point counts, init_configs — including
the restricted ``"pi / 2"``-style arithmetic strings. The data folder is
the repository's, found from this file.
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_PROBLEM_DIRS = (os.path.join(_REPO_ROOT, "data", "problems"),)

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.USub, ast.UAdd, ast.Name,
    ast.Load,
)


def safe_eval(expr: str) -> float:
    """Evaluate an arithmetic expression allowing only ``pi`` and + - * /.

    The AST is whitelisted node-by-node, so no call/attribute/subscript
    syntax survives at all.
    """
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise NameError(f"disallowed syntax in expression: {expr!r}")
        if isinstance(node, ast.Name) and node.id != "pi":
            raise NameError(f"Use of name {node.id} is not allowed")
    return float(eval(compile(tree, "<expr>", "eval"), {"__builtins__": {}},
                      {"pi": np.pi}))


def load_problem(robot: str, problem_type: str) -> dict:
    """Load and normalize a problem JSON: evaluates string entries in init_configs, injects robot_name /
    problem_type, defaults fixed_rotation to None, strips _comments."""
    path = None
    for d in _PROBLEM_DIRS:
        p = os.path.join(d, robot, problem_type + ".json")
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError(
            f"problem {robot}/{problem_type} not found in {_PROBLEM_DIRS}")
    with open(path) as f:
        data = json.load(f)

    data["init_configs"] = [
        [
            safe_eval(str(v))
            if isinstance(v, str)
            and any(op in v for op in ["pi", "+", "-", "*", "/"])
            else v
            for v in config
        ]
        for config in data.get("init_configs", [])
    ]
    data.setdefault("fixed_rotation", None)
    data["robot_name"] = robot
    data["problem_type"] = problem_type
    data.pop("_comments", None)
    return data
