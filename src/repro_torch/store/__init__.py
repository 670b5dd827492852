from repro_torch.store.object_store import NoSuchKey, ObjectStore, StoreStats

__all__ = ["NoSuchKey", "ObjectStore", "StoreStats"]
