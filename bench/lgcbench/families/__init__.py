"""One module a model family: ``port_config(cfg)`` turns a configuration
file into the program's ``ModelConfig``.  ``lgcref.<family>`` holds the
family's weights and loss for the reference."""
