from .message import Message, tree_to_wire, wire_to_tree
from .base_com_manager import BaseCommunicationManager, Observer

__all__ = ["Message", "tree_to_wire", "wire_to_tree",
           "BaseCommunicationManager", "Observer"]
