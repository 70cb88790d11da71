"""Server-side helpers the state store needs (the TTL wheel of timed
watch subscriptions)."""
