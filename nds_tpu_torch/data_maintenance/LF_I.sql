-- Copied from nds_tpu/data_maintenance/LF_I.sql, unchanged.
-- LF_I: refresh-insert inventory from the inventory staging table
-- (role of reference nds/data_maintenance/LF_I.sql, original SQL).
CREATE TEMP VIEW iv AS
SELECT d_date_sk AS inv_date_sk,
       i_item_sk AS inv_item_sk,
       w_warehouse_sk AS inv_warehouse_sk,
       invn_qty_on_hand AS inv_quantity_on_hand
-- join kinds mirror the reference row-for-row (LF_I.sql: every lookup
-- LEFT OUTER; item restricts to the CURRENT SCD record)
FROM s_inventory
LEFT JOIN warehouse ON w_warehouse_id = invn_warehouse_id
LEFT JOIN (SELECT i_item_sk, i_item_id FROM item
           WHERE i_rec_end_date IS NULL) item
  ON i_item_id = invn_item_id
LEFT JOIN date_dim ON d_date = CAST(invn_date AS DATE);
INSERT INTO inventory SELECT * FROM iv;
DROP VIEW iv
