from .message import Message, tree_to_wire, wire_to_tree

__all__ = ["Message", "tree_to_wire", "wire_to_tree"]
