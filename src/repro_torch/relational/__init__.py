from repro_torch.relational.encoding import Dictionary, build_dictionaries, encode_relation
from repro_torch.relational.relation import Database, Relation

__all__ = ["Relation", "Database", "Dictionary", "build_dictionaries", "encode_relation"]
