"""Dense LM of the port: configuration, layers, assembly and weight
conversion from the reference's parameter pytree."""
