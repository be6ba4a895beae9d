"""Storage layer: typed tables, KV transactions, cursors, providers.

A copy of the JAX package's ``storage`` core (the reference's
crates/storage/{db-api,db,provider}: the `Database`/`DbTx`/`DbCursorRO`
traits, the typed schema, and the `ProviderFactory`/`DatabaseProvider`
facade) over the in-memory ``MemDb``. Not ported yet (ROADMAP A item 8):
``open_database``, the native stores, the WAL and static files.
"""

from .kv import Cursor, Database, MemDb, Tx
from .provider import DatabaseProvider, ProviderFactory
from .tables import TableDef, Tables

__all__ = [
    "Database",
    "Tx",
    "Cursor",
    "MemDb",
    "Tables",
    "TableDef",
    "ProviderFactory",
    "DatabaseProvider",
]
