DEFAULT_MODULE_ID = "default_policy"
