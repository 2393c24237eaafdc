"""Typed outcome codes for planning / control actions.

Parity with the Move Base Flex action-result codes the reference plugins
return (documented at mbf_mesh_core/include/mbf_mesh_core/mesh_planner.h:73-84
and used throughout dijkstra_mesh_planner.cpp / cvp_mesh_planner.cpp /
mesh_controller.cpp). Values are int32 so they can live inside device tensors.
"""

from __future__ import annotations

import enum


class Outcome(enum.IntEnum):
    # GetPath (planner) outcomes — mbf_msgs/action/GetPath result codes
    SUCCESS = 0
    FAILURE = 50
    CANCELED = 51
    INVALID_START = 52
    INVALID_GOAL = 53
    NO_PATH_FOUND = 54
    PAT_EXCEEDED = 55
    EMPTY_PATH = 56
    TF_ERROR = 57
    NOT_INITIALIZED = 58
    INVALID_PLUGIN = 59
    INTERNAL_ERROR = 60
    OUT_OF_MAP = 61
    MAP_ERROR = 62
    STOPPED = 63

    # ExePath (controller) outcomes share the SUCCESS/CANCELED/... numbering;
    # the controller-specific ones used by the reference:
    # OUT_OF_MAP (mesh_controller.cpp:96), FAILURE (mesh_controller.cpp:155).


__all__ = ["Outcome"]
